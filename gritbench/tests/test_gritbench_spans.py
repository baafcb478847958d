"""The span reader on synthetic chrome traces: kernels attributed to the
program's ``grit.*`` span in which their launch started, on any thread and
to every span around it; device-idle time intersected with a span; the
benchmark's own ranges and the device's copies of a span left out; and
nothing read from a lost trace or a program without the span."""

from __future__ import annotations

import pytest

from gritbench import harness, spans
from gritbench import trace as T

from .test_gritbench_trace import ev

#: the metrics that read the spans, and the span each reads
NEW = {"backbone_ms.caption": "grit.backbone", "det_module_ms.caption": "grit.det_module",
       "beam_sort_ms.caption": "grit.beam_sort", "cache_reorder_ms.caption": "grit.cache_reorder",
       "decode_idle_ms.caption": "grit.beam_search", "forward_ms.train": "grit.forward",
       "criterion_ms.train": "grit.criterion", "backward_ms.train": "grit.backward",
       "optimizer_ms.train": "grit.optimizer", "forward_idle_ms.train": "grit.forward",
       "backward_idle_ms.train": "grit.backward"}


def step_events():
    """A stretch of 0-1000 us holding one training step on the main thread
    (tid 1): the forward with the backbone and the detector nested in it,
    the criterion, the backward (its kernels launched from tid 2) and the
    optimizer; the benchmark's own range around all of it; the device's copy
    of a span (``gpu_user_annotation``) over the whole stretch."""
    return [
        ev(T.STRETCH, "user_annotation", 0, 1000),
        ev("gritbench.train_step", "user_annotation", 5, 990),
        ev("grit.backward", "gpu_user_annotation", 0, 1000, tid=7),
        ev("grit.forward", "user_annotation", 10, 290),
        ev("grit.backbone", "user_annotation", 20, 130),
        ev("grit.det_module", "user_annotation", 160, 130),
        ev("grit.criterion", "user_annotation", 300, 50),
        ev("grit.backward", "user_annotation", 360, 440),
        ev("grit.optimizer", "user_annotation", 810, 90),
        ev("cudaLaunchKernel", "cuda_runtime", 25, 2, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 170, 2, corr=2),
        ev("cudaLaunchKernel", "cuda_runtime", 400, 2, corr=3, tid=2),
        ev("cudaLaunchKernel", "cuda_runtime", 500, 2, corr=4, tid=2),
        ev("cudaLaunchKernel", "cuda_runtime", 820, 2, corr=5),
        ev("cudaLaunchKernel", "cuda_runtime", 950, 2, corr=6),
        ev("swin_kernel", "kernel", 30, 50, corr=1, tid=7),
        ev("msda_kernel", "kernel", 170, 30, corr=2, tid=7),
        ev("win_attn_bwd_kernel", "kernel", 400, 50, corr=3, tid=7),
        ev("sgemm_kernel", "kernel", 500, 200, corr=4, tid=7),
        ev("Memcpy DtoD", "gpu_memcpy", 720, 20, tid=7),
        ev("adam_kernel", "kernel", 820, 60, corr=5, tid=7),
        ev("read_loss", "kernel", 950, 40, corr=6, tid=7),
    ]


def record(events, units=1, lost=()):
    return {"stretch": {"trace": T.Trace(events), "units": units, "deltas": {},
                        "lost": list(lost)}}


def test_kernels_launched_on_another_thread_belong_to_the_span():
    rec = record(step_events())
    # both launched from tid 2 while tid 1 sat inside grit.backward
    assert spans.device_ms(rec, "grit.backward") == pytest.approx(0.25)
    assert spans.device_ms(rec, "grit.optimizer") == pytest.approx(0.06)


def test_nested_spans_count_toward_their_parents():
    rec = record(step_events())
    assert spans.device_ms(rec, "grit.backbone") == pytest.approx(0.05)
    assert spans.device_ms(rec, "grit.det_module") == pytest.approx(0.03)
    assert spans.device_ms(rec, "grit.forward") == pytest.approx(0.08)
    # present, with no kernel launched inside: a reading of 0, not None
    assert spans.device_ms(rec, "grit.criterion") == 0.0


def test_idle_intersected_with_a_span_is_exact():
    rec = record(step_events())
    # forward 10-300, busy 30-80 and 170-200: 290 - 80 us idle
    assert spans.idle_ms(rec, "grit.forward") == pytest.approx(0.21, abs=1e-12)
    # backward 360-800, busy 400-450, 500-700 and the memcpy 720-740
    assert spans.idle_ms(rec, "grit.backward") == pytest.approx(0.17, abs=1e-12)
    assert spans.idle_ms(rec, "grit.criterion") == pytest.approx(0.05, abs=1e-12)


def test_several_intervals_and_units():
    """Two decode steps' spans, two batches: each interval counts once, the
    sum over the units."""
    events = [ev(T.STRETCH, "user_annotation", 0, 400),
              ev("grit.beam_sort", "user_annotation", 100, 10),
              ev("grit.beam_sort", "user_annotation", 300, 10),
              ev("cudaLaunchKernel", "cuda_runtime", 105, 1, corr=1),
              ev("cudaLaunchKernel", "cuda_runtime", 200, 1, corr=2),
              ev("cudaLaunchKernel", "cuda_runtime", 305, 1, corr=3),
              ev("radix_sort", "kernel", 106, 30, corr=1, tid=7),
              ev("other", "kernel", 201, 30, corr=2, tid=7),
              ev("radix_sort", "kernel", 306, 2, corr=3, tid=7)]
    rec = record(events, units=2)
    assert spans.device_ms(rec, "grit.beam_sort") == pytest.approx(0.016)
    # idle inside the spans: 100-106, 300-306 and 308-310 of 20 us
    assert spans.idle_ms(rec, "grit.beam_sort") == pytest.approx(0.007, abs=1e-12)


def test_benchmark_ranges_and_device_copies_are_not_spans():
    tr = T.Trace(step_events())
    assert spans.span_intervals(tr, "grit.backward") == [(360.0, 800.0)]
    assert spans.span_intervals(tr, "grit.train_step") == []
    rec = record([e for e in step_events() if not e["name"].startswith("grit.")])
    assert all(spans.device_ms(rec, s) is None and spans.idle_ms(rec, s) is None
               for s in set(NEW.values()))


def test_lost_or_missing_reads_none():
    assert spans.device_ms(record(step_events(), lost=["adam: 0 of 1"]), "grit.forward") is None
    assert spans.idle_ms(record(step_events(), lost=["adam: 0 of 1"]), "grit.forward") is None
    assert spans.device_ms({"stretch": None}, "grit.forward") is None
    assert spans.device_ms(record([e for e in step_events() if e["cat"] != "kernel"]),
                           "grit.forward") is None
    assert spans.device_ms(record(step_events()), "grit.beam_sort") is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_metric_files_read_their_span(name):
    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == name)
    assert (entry["unit"], entry["better"], entry["source"]) == ("ms", "lower", "device_trace")
    reader = harness.load_module(harness.ROOT / "metrics" / f"{name}.py", "m_" + name)
    step = step_events() + [ev(s, "user_annotation", 905, 10) for s in NEW.values()
                            if s not in {e["name"] for e in step_events()}]
    read = spans.idle_ms if "idle" in name else spans.device_ms
    assert reader.read(record(step)) == read(record(step), NEW[name]) is not None
    # the parent's program has no span: the metric is left out
    assert reader.read(record([e for e in step if not e["name"].startswith("grit.")])) is None
