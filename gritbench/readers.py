"""What the per-layer readers share: the trace of a run's profiled stretch,
when it holds every launch the program counted."""

from __future__ import annotations

from gritbench import peaks
from gritbench.counts.swin import gemm_least_s

GEMM = {"bfloat16": ("gemm_bf16", r"gemm_bf16_sm90_kernel"),
        "float32": ("gemm_f32", r"gemm_f32_kernel")}


def stretch(rec: dict):
    """(trace, units) of the profiled stretch, or None where the run has no
    device trace or its trace lost launches."""
    s = rec.get("stretch")
    if not s or s["lost"] or not s["trace"].kernels:
        return None
    return s["trace"], s["units"]


def device_ms_per_unit(rec: dict, ranges: tuple[str, ...]) -> float | None:
    got = stretch(rec)
    if got is None:
        return None
    tr, units = got
    ms = tr.device_s(ranges=ranges) * 1e3 / units
    return ms if ms > 0 else None


def launches_per_unit(rec: dict) -> float | None:
    got = stretch(rec)
    if got is None:
        return None
    tr, units = got
    return len(tr.kernels) / units


def idle_share(rec: dict) -> float | None:
    got = stretch(rec)
    if got is None:
        return None
    tr, _ = got
    return 1.0 - tr.busy_s() / tr.span_s


def mfu_percent(rec: dict) -> float | None:
    """Model operations of the window's work over its seconds, as a share of
    the configuration type's peak."""
    w = rec["window"]
    if not rec.get("flops_per_unit") or not rec.get("stretch") or w["seconds"] <= 0:
        return None
    return 100.0 * rec["flops_per_unit"] * w["units"] / w["seconds"] / peaks.FLOPS[rec["dtype"]]


def gemm_roofline_percent(rec: dict) -> float | None:
    """The least time of every GEMM launch in the stretch (shapes from the
    configuration) over their device time; silent unless the trace holds as
    many launches as the counts list."""
    got = stretch(rec)
    if got is None:
        return None
    tr, units = got
    counter, pattern = GEMM[rec["dtype"]]
    launches = rec["gemm_launches"]
    n = tr.count(pattern)
    if n == 0 or n != len(launches) * units or rec["stretch"]["deltas"].get(counter) != n:
        return None
    least = units * sum(gemm_least_s(g, peaks.BYTES[rec["dtype"]], peaks.FLOPS[rec["dtype"]],
                                     peaks.HBM_BYTES_PER_S) for g in launches)
    return 100.0 * least / tr.device_s(pattern=pattern)


def peak_mem_gib(rec: dict) -> float | None:
    peak = rec.get("peak_mem_bytes")
    return peak / 2 ** 30 if peak else None
