"""Device time by kernel from a torch.profiler chrome trace (the counterpart
of the JAX package's tools/agg_trace.py, which read xplane protobufs).

  python -m grit_tpu_torch.tools.agg_trace TRACE [--top 40] [--by-class] [--by-span]

TRACE is a chrome-trace JSON that ``torch.profiler.profile(...).
export_chrome_trace`` wrote (``.json`` or ``.json.gz``; ``bench_train
--trace`` and ``profile_eval --trace`` write them), or a directory whose
traces are reported one by one.  For each trace it sums the device events
(kernels, memcpy and memset: the ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` categories) by name, prints the top ``--top`` with their
launch counts, with ``--by-class`` the sums by kind of kernel (the port's
hand-written kernels by name, then the library's), and with ``--by-span``
the device ms of the kernels launched inside each of the port's ``grit.*``
spans (``utils.misc.trace_annotation``): a kernel belongs to every span in
whose interval its launch record (matched by correlation id) starts, on any
thread, so nested spans count toward their parents.  Busy time is the union
of the device events' intervals inside the window; the idle share is 1 -
busy / the window, which runs from the first ``grit.*`` span's start to the
last one's end, or without spans from the first device event's start to the
last one's end (host set-up before the work is no idle time).  A trace
without device events (one taken on the CPU) is summed over its host
operators instead, and says so.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import re
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the categories of host ranges and of the host's launch records
HOST_RANGES = ("user_annotation", "cpu_op")
LAUNCHES = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "grit."

CLASSES = [
    ("gemm (hand-written)", r"gemm_bf16_sm90|gemm_f32_kernel"),
    ("window attention (hand-written)", r"win_attn|window_attn"),
    ("LayerNorm / merge (hand-written)", r"\bln_(rows|merge)"),
    ("MSDA (hand-written)", r"msda"),
    ("decode-layer tail (hand-written)", r"\bdt_\w+_kernel"),
    ("Adam (hand-written)", r"adam_kernel"),
    ("matcher (hand-written)", r"lsa_kernel"),
    ("cuBLAS / cuDNN products", r"sm90_xmma|gemm|cutlass|cublas|sm80_|ampere_|conv|implicit|nchw"),
    ("sort / top-k", r"radix|sort|topk"),
    ("memcpy / memset", r"memcpy|memset|copy"),
    ("reduction", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def classify(name: str) -> str:
    low = name.lower()
    for label, rx in CLASSES:
        if re.search(rx, low):
            return label
    return "other"


def trace_files(path: str) -> list[Path]:
    p = Path(path)
    if p.is_dir():
        files = sorted(f for f in p.rglob("*") if f.name.endswith((".json", ".json.gz")))
        if not files:
            raise SystemExit(f"agg_trace: no .json or .json.gz trace under {path}")
        return files
    if not p.exists():
        raise SystemExit(f"agg_trace: {path} does not exist")
    return [p]


def load_events(path: Path) -> list[dict]:
    raw = path.read_bytes()
    if path.name.endswith(".gz"):
        raw = gzip.decompress(raw)
    data = json.loads(raw)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def union_ms(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (microseconds in, ms out)."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def interval(e: dict) -> tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def grit_spans(events: list[dict]) -> dict[str, list[tuple[float, float]]]:
    """The host intervals of each ``grit.*`` span."""
    spans: dict[str, list] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in HOST_RANGES and str(e.get("name", "")).startswith(SPAN_PREFIX):
            spans[e["name"]].append(interval(e))
    return dict(spans)


def by_span(events: list[dict], spans: dict) -> dict[str, float]:
    """Device ms of the kernels launched inside each of ``spans``."""
    launch = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCHES and corr is not None:
            launch[corr] = float(e["ts"])
    out = {}
    for name, iv in spans.items():
        ms = 0.0
        for k in events:
            if k.get("cat") != "kernel":
                continue
            t = launch.get((k.get("args") or {}).get("correlation"))
            if t is not None and any(s <= t <= e for s, e in iv):
                ms += float(k["dur"]) / 1e3
        out[name] = ms
    return out


def aggregate(events: list[dict]) -> dict:
    """-> {"device": bool, "by_name": {name: [ms, count]}, "by_class": {...},
    "by_span": {span: ms}, "busy_ms", "span_ms", "idle_share"}."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    chosen = dev or [e for e in events if e.get("cat") == "cpu_op"]
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    by_class: dict[str, float] = collections.Counter()
    for e in chosen:
        ms = float(e["dur"]) / 1e3
        by_name[e["name"]][0] += ms
        by_name[e["name"]][1] += 1
        by_class[classify(e["name"])] += ms
    spans = grit_spans(events)
    bounds = [iv for ivs in spans.values() for iv in ivs] or [interval(e) for e in chosen]
    t0 = min((s for s, _ in bounds), default=0.0)
    t1 = max((e for _, e in bounds), default=0.0)
    span = (t1 - t0) / 1e3
    busy = union_ms([(max(s, t0), min(e, t1)) for s, e in map(interval, chosen)
                     if s < t1 and e > t0])
    return {"device": bool(dev), "by_name": dict(by_name), "by_class": dict(by_class),
            "by_span": by_span(events, spans) if dev else {}, "busy_ms": busy, "span_ms": span,
            "idle_share": 1.0 - busy / span if span > 0 else None}


def report(path: Path, agg: dict, top: int, by_class: bool, spans: bool) -> None:
    what = ("device events" if agg["device"] else
            "host operators, inclusive (no device events: a CPU trace)")
    n = sum(c for _, c in agg["by_name"].values())
    idle = "n/a" if agg["idle_share"] is None else f"{agg['idle_share']:.3f}"
    print(f"== {path}: {n} {what}; busy {agg['busy_ms']:.3f} ms of a {agg['span_ms']:.3f} ms "
          f"window, idle share {idle} ==")
    if by_class:
        print("-- by class (ms) --")
        for cls, ms in sorted(agg["by_class"].items(), key=lambda kv: -kv[1]):
            print(f"{ms:10.3f}  {cls}")
    if spans:
        print("-- by grit.* span, kernels launched inside it (device ms) --")
        for name, ms in sorted(agg["by_span"].items(), key=lambda kv: -kv[1]):
            print(f"{ms:10.3f}  {name}")
    print(f"-- top {top} (ms, launches) --")
    rows = sorted(agg["by_name"].items(), key=lambda kv: -kv[1][0])[:top]
    for name, (ms, count) in rows:
        print(f"{ms:10.3f} {count:6d}x  {name[:120]}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m grit_tpu_torch.tools.agg_trace")
    ap.add_argument("trace", help="a chrome-trace .json / .json.gz, or a directory of them")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--by-class", action="store_true")
    ap.add_argument("--by-span", action="store_true",
                    help="device ms of the kernels launched inside each grit.* span")
    args = ap.parse_args(argv)
    out = {}
    for path in trace_files(args.trace):
        out[str(path)] = aggregate(load_events(path))
        report(path, out[str(path)], args.top, args.by_class, args.by_span)
    return out


if __name__ == "__main__":
    main()
