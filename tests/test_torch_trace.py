"""The port's spans (``utils.misc.trace_annotation``) on the CPU, in a tiny
caption batch, an XE step and a detector step:

- with the profiler off the helper never reaches ``record_function``;
- under ``torch.profiler`` the ``grit.*`` spans are ``user_annotation``
  events of its trace, once a decode step for the sort and the cache
  reorder, the backbone and the detector nested in the training forward, and
  the forward's own operators inside ``grit.forward`` on the same clock;
- tokens, losses and updated parameters are the same bits either way.
"""

import json

import numpy as np
import pytest
import torch

from grit_tpu_torch.utils.nested import ImageBatch

TINY = ["model.backbone=swin_test", "model.grid_feat_dim=64", "model.detector.num_levels=2",
        "dataset.transform_cfg.size=[64, 96]", "model.beam_size=2", "model.beam_len=6",
        "model.vocab_size=19", "exp.device=cpu"]
TINY_DET = ["model.backbone=swin_test", "model.detector.d_model=32",
            "model.detector.dim_feedforward=64", "model.detector.num_heads=4",
            "model.detector.num_layers=2", "model.detector.num_levels=2",
            "model.detector.num_points=2", "model.detector.num_queries=6",
            "model.detector.num_classes=8", "dataset.max_boxes=4"]
CASES = ["caption", "xe", "det"]
SPANS = {"caption": {"grit.backbone", "grit.det_module", "grit.beam_search", "grit.beam_sort",
                     "grit.cache_reorder"},
         "xe": {"grit.forward", "grit.backbone", "grit.det_module", "grit.criterion",
                "grit.backward", "grit.optimizer"}}
SPANS["det"] = SPANS["xe"]
#: operators that only the model's forward calls in a training step: the
#: backward runs their ``*_backward`` operators, the criterion and the
#: optimizer none of them (products are left out: the Swin kernels' backward
#: recomputes some with ``aten::linear``)
FORWARD_OPS = ("aten::convolution", "aten::layer_norm")


def images(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return ImageBatch(torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)),
                      torch.zeros((b, h, w), dtype=torch.bool))


def caption_case():
    """-> (run: () -> {name: tensor}, counts {"steps": decode steps run})."""
    from grit_tpu_torch.engine.evaluator import make_caption_generator
    from grit_tpu_torch.eval_caption import caption_config
    from grit_tpu_torch.models.captioner import build_captioner

    config = caption_config(TINY)
    m = config.model
    model = build_captioner(config, device="cpu", seed=0)
    counts = {"steps": 0}
    decode_step = model.decode_step

    def counted(*a, **k):
        counts["steps"] += 1
        return decode_step(*a, **k)

    model.decode_step = counted
    generate = make_caption_generator(model, beam_size=m.beam_size, max_len=m.beam_len,
                                      bos_idx=m.bos_idx, eos_idx=m.eos_idx)
    batch = images(2, *config.dataset.transform_cfg.size)
    return (lambda: {"tokens": generate(batch, 2)}), counts


def xe_case():
    from grit_tpu_torch.engine import optim, xe
    from grit_tpu_torch.eval_caption import caption_config
    from grit_tpu_torch.models.captioner import build_captioner

    config = caption_config(TINY)
    m = config.model
    model = build_captioner(config, device="cpu", seed=0, train=True)
    opt = optim.build_optimizer(model, model_lr=1e-4, backbone_lr=1e-5)
    state = xe.TrainState(model, opt, global_steps=1,
                          generator=torch.Generator().manual_seed(0))
    step = xe.make_xe_train_step(pad_idx=m.pad_idx, sched_cfg=dict(
        num_epochs=10, num_its_per_epoch=1000, init_lr=1e-4, min_lr=1e-4, warmup_init_lr=1e-5))
    rng = np.random.default_rng(1)
    caps = np.concatenate([np.full((2, 1), m.bos_idx), rng.integers(4, m.vocab_size, (2, 5)),
                           np.full((2, 1), m.eos_idx)], axis=1)
    batch = {"samples": images(2, *config.dataset.transform_cfg.size),
             "captions": torch.from_numpy(caps)}

    def run():
        loss = step(state, batch)[1]["loss"]
        return {"loss": loss, **{n: p.detach().clone() for n, p in model.named_parameters()}}

    return run, {}


def det_case():
    from grit_tpu_torch.config import default_detection_config
    from grit_tpu_torch.detection import solver
    from grit_tpu_torch.detection.detector import build_detection_model
    from grit_tpu_torch.engine import optim, xe

    config = default_detection_config().apply_overrides(TINY_DET)
    model, crit = build_detection_model(config, device="cpu", seed=0)
    o = config.optimizer
    opt = optim.build_detector_optimizer(model, lr=o.lr, lr_backbone=o.lr_backbone,
                                         sp_lr=o.sp_lr, weight_decay=o.weight_decay,
                                         sp_names=list(o.sp_names))
    state = xe.TrainState(model, opt, global_steps=0, generator=torch.Generator().manual_seed(0))
    step = solver.make_detector_train_step(crit, clip_max_norm=o.clip_max_norm)
    rng = np.random.default_rng(2)
    g = int(config.dataset.max_boxes)
    boxes = np.concatenate([rng.uniform(.3, .7, (2, g, 2)), rng.uniform(.05, .2, (2, g, 2))], -1)
    targets = {"labels": torch.from_numpy(rng.integers(0, 8, (2, g))),
               "boxes": torch.from_numpy(boxes.astype(np.float32)),
               "valid": torch.tensor([[True, True, True, False]] * 2)}
    samples = images(2, 64, 64)

    def run():
        metrics = step(state, samples, targets)[1]
        return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                **{n: p.detach().clone() for n, p in model.named_parameters()}}

    return run, {}


BUILD = {"caption": caption_case, "xe": xe_case, "det": det_case}


def profiled(run, tmp_path):
    """``run()`` under torch.profiler (CPU) -> (its outputs, the complete
    events of the exported chrome trace)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    return out, events


def span_events(events):
    spans = {}
    for e in events:
        if str(e.get("name", "")).startswith("grit."):
            assert e["cat"] == "user_annotation", e
            spans.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + e["dur"]))
    return spans


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("case", CASES)
def test_spans_off_never_call_record_function(case, monkeypatch):
    run, _ = BUILD[case]()

    def refuse(*a, **k):
        raise AssertionError("record_function called with the profiler off")

    # the helper's own; torch's optimizers open ranges of their own
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    run()
    # the patch is the one the helper reaches once the profiler records
    from torch.profiler import ProfilerActivity, profile

    from grit_tpu_torch.utils.misc import trace_annotation

    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError):
        trace_annotation("grit.forward")


@pytest.mark.parametrize("case", CASES)
def test_spans_on_the_profiler_timeline(case, tmp_path):
    run, counts = BUILD[case]()
    _, events = profiled(run, tmp_path)
    spans = span_events(events)
    assert set(spans) == SPANS[case]
    if case == "caption":
        (search,) = spans["grit.beam_search"]
        assert 0 < counts["steps"] <= 6
        for name in ("grit.beam_sort", "grit.cache_reorder"):
            assert len(spans[name]) == counts["steps"], name
            assert all(inside(s, search) for s in spans[name])
        (backbone,), (det,) = spans["grit.backbone"], spans["grit.det_module"]
        assert backbone[1] <= det[0] and det[1] <= search[0]
        return
    phases = [spans[n] for n in ("grit.forward", "grit.criterion", "grit.backward",
                                 "grit.optimizer")]
    assert all(len(p) == 1 for p in phases)
    order = [p[0] for p in phases]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    forward = order[0]
    (backbone,), (det,) = spans["grit.backbone"], spans["grit.det_module"]
    assert inside(backbone, forward) and inside(det, forward) and backbone[1] <= det[0]
    # the forward's operators, on the profiler's clock, lie inside its span
    ops = [(float(e["ts"]), float(e["ts"]) + e["dur"]) for e in events
           if e.get("cat") == "cpu_op" and e["name"] in FORWARD_OPS]
    assert ops and all(inside(op, forward) for op in ops)
    convs = [op for op in ops if op[0] >= backbone[0] and op[1] <= backbone[1]]
    assert convs, "the backbone's patch embedding runs inside grit.backbone"


@pytest.mark.parametrize("case", CASES)
def test_outputs_are_the_same_bits_with_the_profiler_on(case, tmp_path):
    # one thread: the CPU's parallel reductions in the backward vary in their
    # order from run to run, profiler or not
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off = BUILD[case]()[0]()
        on, _ = profiled(BUILD[case]()[0], tmp_path)
    finally:
        torch.set_num_threads(threads)
    assert set(on) == set(off)
    for name in off:
        assert torch.equal(on[name], off[name]), name
