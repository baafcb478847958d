"""The port's measuring tools on the CPU, at tiny sizes.

``python -m grit_tpu_torch.tools.{bench_train,profile_eval,bench_epoch}`` run
with ``--device cpu`` / ``exp.device=cpu`` and print their lines;
``agg_trace`` sums a torch.profiler trace taken on the CPU (host operators)
and a hand-made one with device events; without a card and without the CPU
asked for, each device tool raises, as the trainers do.  Times here are the
host's and are checked only for being finite.
"""

import gzip
import json
import math
import os

import numpy as np
import pytest
import torch

from grit_tpu_torch.tools import agg_trace, bench_epoch, bench_train, profile_eval

TINY = ["model.backbone=swin_test", "model.grid_feat_dim=64", "model.detector.num_levels=2",
        "dataset.transform_cfg.size=[64, 96]", "model.beam_size=2", "model.beam_len=6"]
TINY_DET = ["model.backbone=swin_test", "model.detector.d_model=32",
            "model.detector.dim_feedforward=64", "model.detector.num_heads=4",
            "model.detector.num_layers=2", "model.detector.num_levels=2",
            "model.detector.num_points=2", "model.detector.num_queries=6",
            "model.detector.num_classes=8", "dataset.max_boxes=4"]


def test_bench_train_times_xe_and_scst_steps(capsys, tmp_path):
    recs = bench_train.main(["--phase", "both", "--batches", "2", "--sc-batches", "2",
                             "--iters", "1", "--device", "cpu", "--trace", str(tmp_path),
                             "model.vocab_size=19", *TINY])
    out = capsys.readouterr().out
    assert "bench_train on cpu" in out
    assert [r["phase"] for r in recs] == ["XE fs=2", "SC beam=2 fs=2"]
    for r in recs:
        assert r["batch"] == 2 and math.isfinite(r["ms"]) and r["peak_mb"] is None
        assert f"[{r['phase']} b=2] first step" in out and "median step" in out
        assert "chained x2" in out and os.path.exists(r["trace"])


def test_bench_train_times_detector_steps(capsys):
    recs = bench_train.main(["--phase", "det", "--det-batches", "2", "--det-size", "64,64",
                             "--iters", "1", "exp.device=cpu", *TINY_DET])
    out = capsys.readouterr().out
    # the CPU takes the host solver: "auto" resolves by the costs' device
    assert len(recs) == 1 and recs[0]["phase"] == "DET 64x64 match=host"
    assert math.isfinite(recs[0]["grad_norm"]) and "[DET b=2] grad_norm" in out


def test_profile_eval_splits_a_caption_batch_and_traces_it(capsys, tmp_path):
    out = profile_eval.main(["2", "--device", "cpu", "--trace", str(tmp_path),
                             "model.vocab_size=19", *TINY])
    text = capsys.readouterr().out
    assert list(out["phases_ms"]) == ["backbone (Swin)", "detector (Swin+projs+det)",
                                      "compute_vis (det+grid_net)", "precompute_vis_kv",
                                      "decode (20 steps)", "FULL generate"]
    assert all(math.isfinite(v) and v > 0 for v in out["phases_ms"].values())
    assert "attribution at batch 2 (ms):" in text and "img/s" in text
    # the trace of the full batch, summed by agg_trace: a CPU trace has no
    # device events, so its host operators are summed instead
    agg = agg_trace.main([str(tmp_path), "--top", "5", "--by-class"])
    (path, res), = agg.items()
    assert path == out["trace"] and not res["device"]
    assert res["by_name"] and 0 < res["busy_ms"] <= res["span_ms"]
    assert "no device events" in capsys.readouterr().out


def _event(name, ts, dur, cat="kernel", tid=7, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_agg_trace_sums_device_events_of_a_hand_made_trace(tmp_path, capsys):
    """Device time by name and by class, launch counts, busy time as the union
    of overlapping device intervals, the idle share over the window from the
    first device event to the last (host set-up before it left out), in a
    .json.gz as well; with ``grit.*`` spans the window is theirs, and
    ``--by-span`` sums the kernels launched inside each span, on any thread,
    nested spans counting toward their parents."""
    events = [
        _event("aten::linear", 0.0, 1000.0, cat="cpu_op"),
        _event("void (anonymous namespace)::gemm_bf16_sm90_kernel<0, false>(...)", 100.0, 200.0),
        _event("void (anonymous namespace)::gemm_bf16_sm90_kernel<0, false>(...)", 250.0, 100.0),
        _event("void grit::lsa_kernel(float const*, long long const*, long long*, int, int)",
               400.0, 50.0),
        _event("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", 500.0, 100.0),
        _event("Memcpy HtoD (Pageable -> Device)", 700.0, 100.0, cat="gpu_memcpy"),
        _event("ProfilerStep#1", 0.0, 900.0, cat="gpu_user_annotation"),
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
    ]
    plain = tmp_path / "t.json"
    plain.write_text(json.dumps({"traceEvents": events}))
    zipped = tmp_path / "sub" / "t.json.gz"
    zipped.parent.mkdir()
    zipped.write_bytes(gzip.compress(json.dumps(events).encode()))
    for path in (plain, zipped):
        res = agg_trace.main([str(path), "--by-class"])[str(path)]
        assert res["device"]
        gemm = res["by_name"]["void (anonymous namespace)::gemm_bf16_sm90_kernel<0, false>(...)"]
        assert gemm == [pytest.approx(0.3), 2]
        # 100-350 (two overlapping launches), 400-450, 500-600, 700-800: 0.5 ms
        # of the 0.7 ms from the first device event to the last
        assert res["busy_ms"] == pytest.approx(0.5) and res["span_ms"] == pytest.approx(0.7)
        assert res["idle_share"] == pytest.approx(2 / 7)
        assert res["by_class"] == {"gemm (hand-written)": pytest.approx(0.3),
                                   "matcher (hand-written)": pytest.approx(0.05),
                                   "cuBLAS / cuDNN products": pytest.approx(0.1),
                                   "memcpy / memset": pytest.approx(0.1)}
        assert res["by_span"] == {}
    assert set(agg_trace.main([str(tmp_path)])) == {str(plain), str(zipped)}
    assert "idle share 0.286" in capsys.readouterr().out

    # the same device events under the port's spans: the forward (the
    # backbone nested in it) 50-460, the backward 480-900 launching from
    # another thread; the benchmark's own range is no span
    launches = [_event("cudaLaunchKernel", ts, 2, cat="cuda_runtime", tid=tid, corr=c)
                for ts, tid, c in ((90, 1, 1), (240, 1, 2), (390, 1, 3), (490, 2, 4))]
    kernels = [dict(e, args={"correlation": c}) for e, c in zip(events[1:5], (1, 2, 3, 4))]
    spanned = [events[0], *kernels, events[5], *launches,
               _event("grit.forward", 50.0, 410.0, cat="user_annotation", tid=1),
               _event("grit.backbone", 60.0, 200.0, cat="user_annotation", tid=1),
               _event("grit.backward", 480.0, 420.0, cat="user_annotation", tid=1),
               _event("gritbench.train_step", 0.0, 1000.0, cat="user_annotation", tid=1)]
    path = tmp_path / "spans" / "t.json"
    path.parent.mkdir()
    path.write_text(json.dumps(spanned))
    res = agg_trace.main([str(path), "--by-span"])[str(path)]
    # the window 50-900: busy 0.5 ms of 0.85
    assert res["span_ms"] == pytest.approx(0.85) and res["idle_share"] == pytest.approx(0.35 / 0.85)
    assert res["by_span"] == {"grit.forward": pytest.approx(0.35),
                              "grit.backbone": pytest.approx(0.3),
                              "grit.backward": pytest.approx(0.1)}
    out = capsys.readouterr().out
    assert "by grit.* span" in out and "grit.backbone" in out and "gritbench" not in out


def test_bench_epoch_drives_the_trainer_for_one_xe_and_one_scst_epoch(capsys, tmp_path):
    root = tmp_path / "data"
    out = bench_epoch.main(["--root", str(root), "--images", "4", "--wh", "96", "64",
                            "--val-images", "4", "--batch", "2",
                            "exp.device=cpu", "dataset.transform_cfg.randaug=false",
                            "optimizer.num_workers=2", *TINY])
    text = capsys.readouterr().out
    assert out["loader_images_per_s"] > 0 and out["wall_s"] > 0 and out["results"]
    assert "loader-only sustained" in text and "TOTAL recipe wall" in text and "rc=0" in text
    assert (root / "outputs" / "epoch_bench" / "checkpoints").is_dir()
    assert len(np.load(root / "annotations" / "coco_train_ids.npy")) == 20
    # the loader alone, on the same data
    again = bench_epoch.main(["--root", str(root), "--skip-data", "--loader-only", "--batch",
                              "2", "exp.device=cpu",
                              "dataset.transform_cfg.randaug=false", *TINY])
    assert set(again) == {"device", "root", "loader_images_per_s"}
    with pytest.raises(SystemExit):   # never inside the repository
        bench_epoch.main(["--root", str(bench_epoch.REPO / "outputs" / "x"), "exp.device=cpu"])


@pytest.mark.parametrize("tool", ["bench_train", "profile_eval", "bench_epoch"])
def test_device_tools_refuse_a_missing_card(tool, tmp_path):
    assert not torch.cuda.is_available()
    root = tmp_path / "data"
    argv = {"bench_train": ["--phase", "xe"], "profile_eval": ["2"],
            "bench_epoch": ["--root", str(root), "--images", "2"]}[tool]
    with pytest.raises(RuntimeError, match="exp.device=cpu"):
        {"bench_train": bench_train, "profile_eval": profile_eval,
         "bench_epoch": bench_epoch}[tool].main(argv + TINY)
    assert not root.exists()   # bench_epoch asks for the card before writing data


def test_profiler_helpers_on_the_cpu(tmp_path):
    from grit_tpu_torch.utils.misc import (device_memory_mb, start_profiler_trace,
                                           stop_profiler_trace, trace_annotation)

    assert device_memory_mb() is None
    prof = start_profiler_trace(str(tmp_path / "tr"), "cpu")
    with trace_annotation("my_span"):
        torch.ones(4).add_(1)
    path = stop_profiler_trace(prof, "probe")
    assert os.path.basename(path).startswith("probe_")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "my_span" in names
