"""The trace reader on synthetic chrome traces: the union of device
intervals with overlaps, the span of the stretch alone, attribution of
kernels to the range that launched them, and a trace that lost a record
refused."""

from __future__ import annotations

import pytest

from gritbench import trace as T
from gritbench.readers import gemm_roofline_percent, idle_share


def ev(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A stretch from 100 to 200 us: two ranges, four kernels (two overlap)
    and a memcpy; host events before the stretch are set-up."""
    return [
        ev("setup", "cpu_op", 0, 90),
        ev(T.STRETCH, "user_annotation", 100, 100),
        ev("gritbench.compute_vis", "user_annotation", 101, 40),
        ev("gritbench.beam_search", "user_annotation", 150, 40),
        ev("cudaLaunchKernel", "cuda_runtime", 102, 2, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 105, 2, corr=2),
        ev("cudaLaunchKernel", "cuda_runtime", 152, 2, corr=3),
        ev("cudaLaunchKernel", "cuda_runtime", 155, 2, corr=4),
        ev("void gemm_bf16_sm90_kernel<1>", "kernel", 110, 20, corr=1, tid=7),
        ev("void gemm_bf16_sm90_kernel<1>", "kernel", 120, 20, corr=2, tid=8),  # overlaps
        ev("dt_qproj_kernel", "kernel", 160, 10, corr=3, tid=7),
        ev("at::sort", "kernel", 175, 5, corr=4, tid=7),
        ev("Memcpy DtoH", "gpu_memcpy", 185, 5, tid=7),
    ]


def test_union_and_span():
    assert T.union_s([(0, 10), (5, 15), (20, 30)]) == pytest.approx(25e-6)
    tr = T.Trace(synthetic())
    assert tr.span_s == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx((30 + 10 + 5 + 5) * 1e-6)


def test_attribution():
    tr = T.Trace(synthetic())
    assert tr.device_s(ranges=("gritbench.compute_vis",)) == pytest.approx(40e-6)
    assert tr.device_s(ranges=("gritbench.beam_search",)) == pytest.approx(15e-6)
    assert tr.count(r"gemm_bf16_sm90_kernel") == 2


def test_complete_and_lost():
    tr = T.Trace(synthetic())
    assert tr.complete({"gemm_bf16": 2, "win_attn_bf16": 0}) == []
    lost = T.Trace([e for e in synthetic() if e.get("args", {}).get("correlation") != 2
                    or e["cat"] != "kernel"])
    assert lost.complete({"gemm_bf16": 2})
    # a decode-tail call launches 8 kernels: one seen of 8 is a loss
    assert tr.complete({"decode_tail": 1})


def test_lost_trace_is_not_read():
    events = synthetic()
    rec = {"dtype": "bfloat16", "gemm_launches": [{"m": 8, "n": 8, "k": 8, "bias": True,
                                                    "resid": False}] * 2,
           "stretch": {"trace": T.Trace(events), "units": 1, "deltas": {"gemm_bf16": 2},
                       "lost": []}}
    assert idle_share(rec) == pytest.approx(0.5)
    assert gemm_roofline_percent(rec) is not None
    rec["stretch"]["lost"] = ["gemm_bf16: 1 kernels in the trace, 2 launched"]
    assert idle_share(rec) is None and gemm_roofline_percent(rec) is None


def test_breakdown():
    b = T.Trace(synthetic()).breakdown()
    assert b["device_ops"][0][0] == "void gemm_bf16_sm90_kernel<1>"
    assert b["device_ops"][0][1] == pytest.approx(40e-6)
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(50e-6)
