"""What the program's own spans read in the trace of a profiled stretch.

While the profiler records, the port opens ``grit.*`` spans
(``record_function`` through its ``utils.misc.trace_annotation``) at its
layer and step-phase boundaries: ``user_annotation`` events on the
profiler's clock, the clock of its kernel records.  Here:

- a kernel belongs to a span when the start of its launch (the
  ``cuda_runtime`` or ``cuda_driver`` record of the same correlation id)
  falls inside one of the span's intervals, on any thread: ``.backward()``
  launches from autograd's worker thread while the main thread waits inside
  ``grit.backward``; a kernel under nested spans belongs to each of them;
- a span's idle time is the part of its intervals, inside the stretch, in
  which no device event (kernel, memcpy, memset) runs: the gaps in the union
  of those events, as ``Trace.busy_s`` unites them.

Each reading is per unit of the stretch (batch or step), in ms, and None
where ``readers.stretch`` gives none (a lost or empty trace) or where the
trace holds no such span (a program without it).  Only the exact name is
read: the benchmark's own ``gritbench.*`` ranges are never a ``grit.*``
span.
"""

from __future__ import annotations

import bisect

from gritbench.readers import stretch

#: the chrome trace's categories of host ranges (``record_function``); a
#: range's device-side copy (``gpu_user_annotation``) is not one of them
HOST_RANGES = ("user_annotation", "cpu_op")


def merged(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint [start, end] intervals covering ``intervals``."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_intervals(tr, name: str) -> list[tuple[float, float]]:
    """The union of the host intervals of span ``name``, clipped to the
    stretch (microseconds)."""
    return merged((max(float(e["ts"]), tr.t0), min(float(e["ts"]) + float(e["dur"]), tr.t1))
                  for e in tr.events
                  if e.get("name") == name and e.get("cat") in HOST_RANGES
                  and float(e["ts"]) < tr.t1 and float(e["ts"]) + float(e["dur"]) > tr.t0)


def _present(rec: dict, name: str):
    got = stretch(rec)
    if got is None:
        return None
    tr, units = got
    spans = span_intervals(tr, name)
    return (tr, units, spans) if spans else None


def device_ms(rec: dict, name: str) -> float | None:
    """Device ms a unit of the kernels launched inside span ``name``."""
    got = _present(rec, name)
    if got is None:
        return None
    tr, units, spans = got
    starts = [s for s, _ in spans]
    total = 0.0
    for k in tr.kernels:
        launch = tr._launch.get((k.get("args") or {}).get("correlation"))
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[0]) - 1
        if i >= 0 and launch[0] <= spans[i][1]:
            total += float(k["dur"])
    return total / 1e3 / units


def idle_ms(rec: dict, name: str) -> float | None:
    """Device-idle ms a unit while the host is inside span ``name``."""
    got = _present(rec, name)
    if got is None:
        return None
    tr, units, spans = got
    busy = merged((max(float(e["ts"]), tr.t0), min(float(e["ts"]) + float(e["dur"]), tr.t1))
                  for e in tr.device
                  if float(e["ts"]) < tr.t1 and float(e["ts"]) + float(e["dur"]) > tr.t0)
    inside = sum(e - s for s, e in spans)
    return (inside - overlap(spans, busy)) / 1e3 / units
