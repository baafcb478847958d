"""Share of a caption batch's decode steps replayed from a CUDA graph: the
program's ``grit.decode_graph`` host events in the profiled stretch over its
``grit.beam_sort`` host events (one sort a decode step).  Each event counts,
not the union of their intervals.  0.0 where no step replayed from a graph;
None where the stretch holds no ``grit.beam_sort`` event (or ``readers.stretch``
gives none)."""

from gritbench.readers import stretch
from gritbench.spans import HOST_RANGES


def events(tr, name: str) -> int:
    """The host events of span ``name`` that start inside the stretch."""
    return sum(1 for e in tr.events if e.get("name") == name and e.get("cat") in HOST_RANGES
               and tr.t0 <= float(e["ts"]) <= tr.t1)


def read(rec):
    got = stretch(rec)
    if got is None:
        return None
    tr, _ = got
    sorts = events(tr, "grit.beam_sort")
    return events(tr, "grit.decode_graph") / sorts if sorts else None
