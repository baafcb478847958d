"""The profiled stretch of a traced run and what is read from its trace.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (host and device
activities) inside a ``gritbench.stretch`` range and returns the chrome
trace's complete events.  ``Trace`` reads them:

- device events are the ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
  categories; busy time is the union of their intervals inside the stretch,
  and the span is the stretch range's own duration, so set-up before it is
  no idle time;
- each kernel is attributed to the innermost ``gritbench.*`` range around
  the host call that launched it (matched by the launch's correlation id);
- ``complete`` compares the kernels of each counted family in the trace with
  the program's launch counters over the same stretch, so that a trace that
  lost records is not read.

The arithmetic of busy time (a union of intervals) follows the port's
``tools/agg_trace.py``; its span there runs from the trace's first event to
its last, host events included, and here it is the stretch's.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "gritbench.stretch"

#: the program's launch counters -> (the kernel names each counts, kernels a
#: count launches)
COUNTED = {
    "gemm_bf16": (r"gemm_bf16_sm90_kernel", 1),
    "gemm_f32": (r"gemm_f32_kernel", 1),
    "win_attn_bf16": (r"win_attn_mma_kernel", 1),
    "win_attn_f32": (r"win_attn_f32_kernel", 1),
    "win_attn_bwd_bf16": (r"win_attn_bwd_mma_kernel", 1),
    "win_attn_bwd_f32": (r"win_attn_bwd_f32_kernel", 1),
    "msda": (r"\bmsda_kernel", 1),
    "msda_bwd": (r"\bmsda_bwd_kernel", 1),
    "decode_tail": (r"\bdt_\w+_kernel", 8),
    "adam": (r"\badam_kernel", 1),
    "lsa": (r"\blsa_kernel", 1),
}


def union_s(intervals) -> float:
    """Length of the union of [start, end) intervals, microseconds in,
    seconds out."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def profile(fn, directory: str | None = None) -> list[dict]:
    """Run ``fn`` (which ends in a device synchronise) under the profiler ->
    the chrome trace's complete ("X") events.  The trace file lives in
    ``directory`` (default: the temporary directory) only while it is read."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json", dir=directory)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


class Trace:
    def __init__(self, events: list[dict]):
        self.events = events
        stretch = [e for e in events if e.get("name") == STRETCH
                   and e.get("cat") in ("user_annotation", "cpu_op")]
        if stretch:
            s = stretch[0]
            self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        else:
            ts = [float(e["ts"]) for e in events] or [0.0]
            self.t0, self.t1 = min(ts), max(float(e["ts"]) + float(e["dur"]) for e in events)
        self.device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self._ranges = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid"))
            for e in events if e.get("cat") in ("user_annotation", "cpu_op")
            and str(e.get("name", "")).startswith("gritbench.") and e["name"] != STRETCH)
        self._launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self._launch[corr] = (float(e["ts"]), e.get("tid"))

    @property
    def span_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        spans = ((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device)
        return union_s((max(s, self.t0), min(e, self.t1)) for s, e in spans
                       if s < self.t1 and e > self.t0)

    def range_of(self, kernel: dict) -> str | None:
        """The innermost ``gritbench.*`` range around the host call that
        launched ``kernel`` (None outside every range)."""
        launch = self._launch.get((kernel.get("args") or {}).get("correlation"))
        if launch is None:
            return None
        ts, tid = launch
        best = None
        for s, e, name, rtid in self._ranges:
            if s > ts:
                break
            if e >= ts and (tid is None or rtid == tid):
                if best is None or s >= best[0]:
                    best = (s, name)
        return best[1] if best else None

    def device_s(self, pattern: str | None = None, ranges: tuple[str, ...] | None = None) -> float:
        """Summed device seconds of kernels whose name matches ``pattern`` and
        that were launched under one of ``ranges``."""
        total = 0.0
        for k in self.kernels:
            if pattern is not None and not re.search(pattern, k["name"]):
                continue
            if ranges is not None and self.range_of(k) not in ranges:
                continue
            total += float(k["dur"])
        return total / 1e6

    def count(self, pattern: str) -> int:
        return sum(1 for k in self.kernels if re.search(pattern, k["name"]))

    def complete(self, deltas: dict) -> list[str]:
        """The counted families whose kernels in the trace differ from the
        launch counters' deltas over the stretch (empty: nothing lost)."""
        bad = []
        for counter, n in deltas.items():
            if counter not in COUNTED or n == 0:
                continue
            pattern, per = COUNTED[counter]
            seen = self.count(pattern)
            if seen != n * per:
                bad.append(f"{counter}: {seen} kernels in the trace, {n * per} launched")
        return bad

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the host call that was running when each began."""
        by_name = collections.Counter()
        for e in self.device:
            by_name[e["name"]] += float(e["dur"]) / 1e6
        busy = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.device)
        gaps, end = [], self.t0
        for s, e in busy:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1))
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                      for e in self.events if e.get("cat") in ("cpu_op", "cuda_runtime",
                                                               "cuda_driver"))
        starts = [h[0] for h in host]
        by_host = collections.Counter()
        for s, e in gaps:
            name = "(no host call)"
            # the latest-starting host call still running at s: nested calls
            # start close together, so a short look back finds it
            i = bisect.bisect_right(starts, s) - 1
            for hs, he, hn in host[max(0, i - 256):i + 1][::-1]:
                if he > s:
                    name = hn
                    break
            by_host[name] += (e - s) / 1e6
        return {"device_ops": [[n, v] for n, v in by_name.most_common(top)],
                "idle_gaps": [[n, v] for n, v in by_host.most_common(top)]}


def stretch(body, units: int, owner) -> dict:
    """Profile ``body`` (``units`` batches or steps) with ``owner.spans`` on
    and the launch counters read around it -> the record the readers take."""
    owner.spans = True
    before = snapshot()
    try:
        events = profile(body)
    finally:
        owner.spans = False
    d = deltas(before, snapshot())
    tr = Trace(events)
    return {"units": units, "trace": tr, "deltas": d, "lost": tr.complete(d)}


def snapshot() -> dict:
    """The program's launch counters now (``LAUNCHES`` of its op modules)."""
    from grit_tpu_torch.ops import decode_layer, fused_adam, lsa, msda
    from grit_tpu_torch.ops import window_attention as wa

    out = {}
    for mod in (wa, msda, decode_layer, fused_adam, lsa):
        out.update(mod.LAUNCHES)
    return out


def deltas(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}
