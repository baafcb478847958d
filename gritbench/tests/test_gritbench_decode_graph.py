"""``decode_graph_share.caption`` on synthetic chrome traces: the program's
``grit.decode_graph`` host events over its ``grit.beam_sort`` host events,
each event counted; 0.0 without a replayed step, None without a sort."""

from __future__ import annotations

import pytest

from gritbench import harness, spans
from gritbench import trace as T

from .test_gritbench_spans import record
from .test_gritbench_trace import ev

NAME = "decode_graph_share.caption"


def read(rec):
    return harness.load_module(harness.ROOT / "metrics" / f"{NAME}.py",
                               "gritbench_metric_decode_graph_share").read(rec)


def steps(graphed: bool, n: int = 4) -> list[dict]:
    """A stretch of ``n`` decode steps, each a replay (or its eager ops) and
    a sort; one more step's events before the stretch (set-up); the device's
    copy of a span, which is no host event."""
    events = [ev(T.STRETCH, "user_annotation", 0, 100 * n),
              ev("grit.beam_search", "user_annotation", 1, 100 * n - 2),
              ev("grit.beam_sort", "user_annotation", -90, 5),
              ev("grit.decode_graph", "gpu_user_annotation", 0, 100 * n, tid=7),
              ev("cudaLaunchKernel", "cuda_runtime", 3, 1, corr=1),
              ev("dt_attn_kernel", "kernel", 4, 50, corr=1, tid=7)]
    for i in range(n):
        if graphed:
            events.append(ev("grit.decode_graph", "user_annotation", 100 * i + 10, 3))
        # each sort's span touches the next one's: merged, they would be one
        events.append(ev("grit.beam_sort", "user_annotation", 100 * i + 60, 100))
    return events


@pytest.mark.parametrize("graphed, share", [(True, 1.0), (False, 0.0)])
def test_share_of_steps_replayed(graphed, share):
    assert read(record(steps(graphed))) == share


def test_each_event_counts():
    """Two of four steps replayed: 0.5, the sorts' touching spans counted
    one by one (their union is one interval)."""
    events = [e for e in steps(True) if not (e["name"] == "grit.decode_graph"
                                             and e["cat"] == "user_annotation"
                                             and e["ts"] > 200)]
    assert read(record(events)) == 0.5
    assert len(spans.span_intervals(T.Trace(events), "grit.beam_sort")) == 1


def test_none_without_a_sort_or_a_trace():
    no_sort = [e for e in steps(True) if e["name"] != "grit.beam_sort"]
    assert read(record(no_sort)) is None
    assert read(record(steps(True), lost=["decode_tail: 0 of 3"])) is None
    assert read({"stretch": None}) is None
