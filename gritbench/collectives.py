"""What the data-parallel readers take from the trace of rank 0's profiled
stretch: the NCCL kernels (``nccl`` in the kernel's name, any case), which
carry DDP's gradient all-reduce and the step's small sums over the ranks
(the criterion's global box count).

- ``allreduce_ms``: their device ms a step, summed;
- ``allreduce_exposed_ms``: the ms a step in which an NCCL kernel runs and
  no other kernel does: the union of the NCCL intervals less its overlap
  with the union of the other kernels', |N u O| - |O| by ``trace.union_s``.

Both are None where ``readers.stretch`` gives no trace or the trace holds no
NCCL kernel (a run on one card).
"""

from __future__ import annotations

import re

from gritbench.readers import stretch
from gritbench.trace import union_s

NCCL = re.compile("nccl", re.IGNORECASE)


def _intervals(rec: dict):
    """(NCCL intervals, other kernels' intervals, units) in microseconds, or
    None."""
    got = stretch(rec)
    if got is None:
        return None
    tr, units = got
    nccl, other = [], []
    for k in tr.kernels:
        s = float(k["ts"])
        (nccl if NCCL.search(k["name"]) else other).append((s, s + float(k["dur"])))
    return (nccl, other, units) if nccl else None


def allreduce_ms(rec: dict) -> float | None:
    got = _intervals(rec)
    if got is None:
        return None
    nccl, _, units = got
    return sum(e - s for s, e in nccl) / 1e3 / units


def allreduce_exposed_ms(rec: dict) -> float | None:
    got = _intervals(rec)
    if got is None:
        return None
    nccl, other, units = got
    return (union_s(nccl + other) - union_s(other)) * 1e3 / units
