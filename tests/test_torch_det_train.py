"""The port's detector pre-training against the JAX package, on the CPU at fp32.

Tiny twins (Swin depths (2, 2), window 6, 2 levels, 6 queries, 10 classes,
64x96 images, the second image smaller than the bucket; the attribute head on,
so all five optimizer groups hold parameters).  The port's seeded weights
cross to JAX through ``convert.py``; images and targets come from numpy
seeds.  One whole train step (forward, criterion with host matching, backward,
global-norm clip, five-group AdamW) is held against
``grit_tpu.detection.solver.make_detector_train_step``; then the solver with
its hooks, the Valider, and the CLI on synthetic data with a resume.

Tolerances: loss 1e-5 relative; a gradient leaf 1e-4 of its max; an updated
parameter 1e-4 of its max where the gradient is above 1e-6 and two learning
rates elsewhere (Adam's first step is rounding noise of either sign there);
labels, assignments and learning-rate scales exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from grit_tpu.detection import losses as jlosses
from grit_tpu.detection import solver as jsolver
from grit_tpu.engine import optim as joptim
from grit_tpu.engine import xe as jxe
from grit_tpu_torch import convert
from grit_tpu_torch.detection import hooks as thooks
from grit_tpu_torch.detection import losses as tlosses
from grit_tpu_torch.detection import solver as tsolver
from grit_tpu_torch.detection.coco_eval import CocoEvaluator
from grit_tpu_torch.engine import checkpoint as tckpt
from grit_tpu_torch.engine import optim as toptim
from grit_tpu_torch.engine import xe as txe
from grit_tpu_torch.utils.nested import ImageBatch
from test_torch_detection import (N_ATTR, N_CLASSES, _boxes, det_params, jax_detector,
                                  torch_detector)
from test_torch_models import torch_one_thread, uint8_images  # noqa: F401

HYPER = dict(lr=1e-3, lr_backbone=2e-3, sp_lr=5e-3, weight_decay=1e-2)
CLIP = 0.1
SP_NAMES = ["attr_head"]
LR_SCALES = (0.5, 0.25)    # main groups, sp group


def det_targets(seed=40, g=4):
    rng = np.random.default_rng(seed)
    valid = np.arange(g)[None, :] < np.asarray([3, 2])[:, None]
    tg = {"labels": rng.integers(0, N_CLASSES, (2, g)).astype(np.int32),
          "boxes": _boxes(rng, 2, g), "valid": valid,
          "attributes": (rng.uniform(size=(2, g, N_ATTR)) < 0.3).astype(np.float32),
          "has_attr": np.asarray([True, True])}
    tg["labels"][~valid] = 0
    tg["boxes"][~valid] = 0.0
    return tg


def torch_det_state(model, seed=0):
    opt = toptim.build_detector_optimizer(model, sp_names=SP_NAMES, **HYPER)
    return txe.TrainState(model, opt, global_steps=0,
                          generator=torch.Generator().manual_seed(seed))


def torch_det_batch():
    imgs, mask = uint8_images()
    return {"samples": ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)),
            "targets": {k: torch.from_numpy(v) for k, v in det_targets().items()}}


# ---------------------------------------------------------------------------
# labels, groups, decay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp_names", [["attr_head"], ["attr_head", "query_embed"], []])
def test_detector_labels_and_groups_match_jax(sp_names):
    """Every parameter gets the JAX package's group; the optimizer's groups
    carry that group's learning rate, decay only on head / backbone_decay /
    sp, betas (0.9, 0.999), and leave out frozen leaves."""
    model = torch_detector()
    params = det_params(model)["params"]
    groups = list(toptim.DETECTOR_GROUPS)
    jlabels = joptim.detector_param_labels(params, sp_names=sp_names)
    as_sd = convert.params_to_state_dict(jax.tree.map(
        lambda p, lab: np.full(np.shape(p), groups.index(lab)), params, jlabels))
    labels = toptim.detector_param_labels(model, sp_names)
    assert set(as_sd) == set(labels)
    for name, arr in as_sd.items():
        assert (arr == groups.index(labels[name])).all(), name
    assert labels["det_module.query_embed.weight"] == ("sp" if "query_embed" in sp_names
                                                       else "head")
    freeze = toptim.frozen_mask(model, toptim.swin_frozen_stages_predicate(2))
    opt = toptim.build_detector_optimizer(model, sp_names=sp_names, freeze=freeze, **HYPER)
    names = {id(p): n for n, p in model.named_parameters()}
    want_lr = {"head": HYPER["lr"], "det_no_decay": HYPER["lr"],
               "backbone_no_decay": HYPER["lr_backbone"],
               "backbone_decay": HYPER["lr_backbone"], "sp": HYPER["sp_lr"]}
    assert [g["name"] for g in opt.param_groups] == [
        g for g in groups if g != "sp" or sp_names]
    held = set()
    for g in opt.param_groups:
        assert g["lr"] == g["base_lr"] == want_lr[g["name"]] and g["betas"] == (0.9, 0.999)
        decays = g["name"] in ("head", "backbone_decay", "sp")
        assert g["weight_decay"] == (HYPER["weight_decay"] if decays else 0.0)
        for p in g["params"]:
            assert labels[names[id(p)]] == g["name"] and not freeze[names[id(p)]]
            held.add(names[id(p)])
    assert held == {n for n in labels if not freeze[n]} and sum(freeze.values()) > 10
    toptim.apply_detector_lr(opt, 0.5, 0.1)
    for g in opt.param_groups:
        assert g["lr"] == g["base_lr"] * (0.1 if g["name"] == "sp" else 0.5)


# ---------------------------------------------------------------------------
# one whole train step
# ---------------------------------------------------------------------------

def test_detector_train_step_matches_jax(torch_one_thread):
    """One detector update with dropouts off, from the same weights, images
    and targets, at learning-rate scales (0.5, 0.25): the assignments of all
    three prediction levels equal, loss / grad norm / named losses within
    1e-5, every clipped gradient leaf within 1e-4 of its max, every updated
    parameter and both Adam moments within the limits of the module
    docstring, ``level_embed`` (off the path) decayed in both."""
    from grit_tpu.utils.nested import ImageBatch as JaxBatch

    model = torch_detector()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params = det_params(model)
    jmodel = jax_detector()
    jcrit = jlosses.SetCriterion(N_CLASSES, match_impl="host")
    imgs, mask = uint8_images()
    jimages = JaxBatch(jnp.asarray(imgs), jnp.asarray(mask))
    jtargets = {k: jnp.asarray(v) for k, v in det_targets().items()}

    def jloss(p):
        out = jmodel.apply(p, jimages, training=True, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jcrit.total_loss(jcrit(out, jtargets)), out

    (ref_loss, jout), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tx, _ = joptim.build_optimizer(params, beta_2=0.999)
    labels = joptim.detector_param_labels(params, sp_names=SP_NAMES)
    jstep = jsolver.make_detector_train_step(jmodel, jcrit, tx, labels, clip_max_norm=CLIP,
                                             **HYPER)
    jstate, jmetrics = jax.block_until_ready(jstep(
        jxe.TrainState.create(jax.tree.map(jnp.asarray, params), tx), jimages, jtargets,
        jnp.asarray(LR_SCALES, jnp.float32), jax.random.PRNGKey(0)))

    # the matching is discrete: hold the assignments themselves
    tcrit = tlosses.SetCriterion(N_CLASSES)
    batch = torch_det_batch()
    with torch.no_grad():
        tout = model(batch["samples"], training=True)
    tassign = tcrit.match_levels(tout, batch["targets"]).numpy()
    for lvl, o in enumerate([jout] + jout["aux_outputs"]):
        want = jlosses.hungarian_match(o["pred_logits"], o["pred_boxes"], jtargets["labels"],
                                       jtargets["boxes"], jtargets["valid"], impl="host")
        np.testing.assert_array_equal(tassign[lvl], np.asarray(want))

    state = torch_det_state(model)
    step = tsolver.make_detector_train_step(tcrit, clip_max_norm=CLIP)
    state, metrics = step(state, batch["samples"], batch["targets"], *LR_SCALES)

    assert state.global_steps == int(jstate.global_steps) == 1
    assert abs(float(metrics["loss"]) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert set(metrics) == set(jmetrics)
    assert {"loss", "grad_norm", "loss_ce", "loss_bbox", "loss_giou", "loss_attr",
            "class_error", "cardinality_error"} == set(metrics)
    for k in metrics:
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= 1e-5 * max(
            1.0, abs(float(jmetrics[k]))), k

    gnorm = float(jmetrics["grad_norm"])
    clip = min(1.0, CLIP / (gnorm + 1e-6))
    assert clip < 1.0
    ref_g = convert.params_to_state_dict(jax.tree.map(np.asarray, ref_grads["params"]))
    ref_p = convert.params_to_state_dict(jax.tree.map(np.asarray, jstate.params["params"]))
    lrs = {id(p): g["lr"] for g in state.optimizer.param_groups for p in g["params"]}
    tlabels = toptim.detector_param_labels(model, SP_NAMES)
    for name, p in model.named_parameters():
        want_g = ref_g[name] * clip
        err = np.abs(p.grad.numpy() - want_g).max()
        assert err <= 1e-4 * np.abs(want_g).max() + 1e-7, name
        big = np.abs(want_g) > 1e-6
        err = np.abs(p.detach().numpy() - ref_p[name])
        tol = 1e-4 * np.abs(ref_p[name]).max()
        assert (err <= np.where(big, tol, 2 * lrs[id(p)])).all(), name
        assert not torch.equal(p.detach(), before[name]) or not before[name].any(), name
    scale = {"sp": LR_SCALES[1]}
    for g in state.optimizer.param_groups:
        assert g["lr"] == g["base_lr"] * scale.get(g["name"], LR_SCALES[0])
    # off the path, so a zero gradient: it only decays, by lr * wd of itself
    le, le0 = model.det_module.level_embed.detach(), before["det_module.level_embed"]
    assert tlabels["det_module.level_embed"] == "head"
    np.testing.assert_allclose(
        le.numpy(), le0.numpy() * (1 - HYPER["lr"] * LR_SCALES[0] * HYPER["weight_decay"]),
        rtol=1e-6)

    # the five-group Adam state in the JAX package's layout
    mu, nu, count = convert.adam_state_to_trees(model, state.optimizer)
    adam = [s for s in jax.tree.leaves(jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0]
    assert count == int(adam.count) == 1
    # floors: the moments of a gradient that is f32 noise (1e-7) around an exact zero
    for ours, ref, floor in ((mu, adam.mu["params"], 1e-8), (nu, adam.nu["params"], 1e-17)):
        flat, flat_ref = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (ours, ref))
        assert [p for p, _ in flat] == [p for p, _ in flat_ref]
        for (path, a), (_, b) in zip(flat, flat_ref):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max() + floor, str(path)
    fresh = torch_det_state(torch_detector())
    convert.adam_state_from_trees(fresh.model, fresh.optimizer, mu, nu, count)
    for (n, p), (_, q) in zip(model.named_parameters(), fresh.model.named_parameters()):
        st, st2 = state.optimizer.state[p], fresh.optimizer.state[q]
        assert st2["step"] == 1 and torch.equal(st["exp_avg"], st2["exp_avg"]), n
        assert torch.equal(st["exp_avg_sq"], st2["exp_avg_sq"]), n


def test_clip_grad_norm_matches_the_jax_step_formula():
    g = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(s, generator=g)) for s in ((3, 4), (5,), (2, 2, 2))]
    for p in params:
        p.grad = torch.randn(p.shape, generator=g)
    params.append(torch.nn.Parameter(torch.zeros(2)))       # no gradient: skipped
    grads = [p.grad.clone() for p in params[:-1]]
    want = np.sqrt(sum(float((x ** 2).sum()) for x in grads))
    got = tsolver.clip_grad_norm(params, 0.1)
    assert abs(float(got) - want) <= 1e-6 * want
    for p, g0 in zip(params, grads):
        np.testing.assert_allclose(p.grad.numpy(), g0.numpy() * (0.1 / (want + 1e-6)), rtol=1e-6)
    untouched = [p.grad.clone() for p in params[:-1]]
    tsolver.clip_grad_norm(params, 0.0)                      # 0 turns the clip off
    assert all(torch.equal(p.grad, u) for p, u in zip(params, untouched))


# ---------------------------------------------------------------------------
# the solver: hooks, validers, checkpoints
# ---------------------------------------------------------------------------

def _valid_batches():
    imgs, mask = uint8_images(seed=3)
    return [{"samples": ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)),
             "orig_sizes": np.asarray([[128, 192], [80, 144]]), "image_id": [11, 12]}]


def _valid_gt():
    return {11: {"boxes": np.asarray([[10., 20., 90., 100.], [50., 40., 150., 120.]]),
                 "labels": np.asarray([1, 3])},
            12: {"boxes": np.asarray([[5., 5., 60., 70.]]), "labels": np.asarray([2])}}


def test_trainer_runs_hooks_validers_and_checkpoints(torch_one_thread, tmp_path):
    """``Trainer.run_epoch`` over an in-memory loader: the warm-up and epoch
    hooks drive every group's learning rate, the valider runs inside the
    epoch before the checkpoint hook (which keeps the top-k by mAP and
    ``detector_last``), the text and scalar hooks log, and ``detector_last``
    restores the parameters, the optimizer state and the counters."""
    model = torch_detector(dropout=0.1)
    state = torch_det_state(model)
    seen = []

    def step_fn(st, images, targets, lr_scale, sp_lr_scale):
        st, m = inner(st, images, targets, lr_scale, sp_lr_scale)
        seen.append((lr_scale, sp_lr_scale, [g["lr"] for g in st.optimizer.param_groups]))
        return st, m

    inner = tsolver.make_detector_train_step(tlosses.SetCriterion(N_CLASSES), clip_max_norm=CLIP)
    order = []

    class Probe(thooks.Hook):
        def after_epoch(self, solver):
            order.append(dict(solver.epoch_results))

    valider = tsolver.Valider(lambda: trainer.state.model, _valid_batches(),
                              lambda: CocoEvaluator(_valid_gt()), device="cpu")
    hooks = [thooks.WarmupLRHook(4, 0.1), thooks.EpochLRHook([1], 0.5),
             thooks.EpochLRHook([1], 0.1, attr="sp_epoch_lr_scale"), Probe(),
             thooks.TextLoggingHook(str(tmp_path / "log.txt"), every=1),
             thooks.ScalarWriterHook(str(tmp_path / "scalars.jsonl"), every=1),
             thooks.ProgressHook(every=1), thooks.CheckpointHook(str(tmp_path), topk=1)]
    loader = [torch_det_batch(), torch_det_batch()]
    trainer = tsolver.Trainer(step_fn, state, loader, device="cpu", seed=0, hooks=hooks,
                              validers=[valider])
    for epoch in range(2):
        trainer.run_epoch(epoch)
    assert model.training and trainer.global_step == state.global_steps == 4
    want = [(0.1, 0.1), (0.325, 0.325), (0.55 * 0.5, 0.55 * 0.1), (0.775 * 0.5, 0.775 * 0.1)]
    for (main, sp, lrs), (wm, ws) in zip(seen, want):
        assert main == pytest.approx(wm) and sp == pytest.approx(ws)
        for g, lr in zip(state.optimizer.param_groups, lrs):
            assert lr == pytest.approx(g["base_lr"] * (ws if g["name"] == "sp" else wm))
    assert len(order) == 2 and all("mAP" in r for r in order)   # validers ran before the hooks
    ckpts = sorted(os.listdir(tmp_path / "checkpoints"))
    assert "detector_last" in ckpts and len(ckpts) == 2         # top-1 and last
    assert len(open(tmp_path / "scalars.jsonl").readlines()) == 4
    assert "results" in open(tmp_path / "log.txt").read()

    payload = tckpt.restore_checkpoint(str(tmp_path), "detector_last")
    assert payload["epoch"] == 1 and payload["global_steps"] == 4
    fresh = torch_det_state(torch_detector(seed=5, dropout=0.1))
    tckpt.load_train_state(fresh, payload)
    for (n, p), (_, q) in zip(model.named_parameters(), fresh.model.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(state.optimizer.state[p]["exp_avg_sq"],
                           fresh.optimizer.state[q]["exp_avg_sq"]), n
    # the same next step from both: an epoch-keyed dropout stream, equal state
    nxt = []
    for st in (state, fresh):
        st.generator.manual_seed(123)
        nxt.append(float(inner(st, *[torch_det_batch()[k] for k in ("samples", "targets")])[1]["loss"]))
    assert nxt[0] == nxt[1]


def test_valider_summary_equals_the_jax_pipeline(torch_one_thread):
    """``Valider.run_epoch`` (eval() forward -> postprocess -> CocoEvaluator)
    gives the mAP summary that the JAX package's model, postprocess and
    evaluator give from the same weights, images and ground truth."""
    from grit_tpu.detection.coco_eval import CocoEvaluator as JEval
    from grit_tpu.detection.postprocess import postprocess as jpost
    from grit_tpu.utils.nested import ImageBatch as JaxBatch

    model = torch_detector()
    batches = _valid_batches()
    valider = tsolver.Valider(lambda: model, batches, lambda: CocoEvaluator(_valid_gt()),
                              device="cpu")
    got = valider.run_epoch(0)
    assert model.training            # left as it was found
    jeval = JEval(_valid_gt())
    jmodel = jax_detector()
    for b in batches:
        out = jmodel.apply(det_params(model), JaxBatch(jnp.asarray(b["samples"].images.numpy()),
                                                       jnp.asarray(b["samples"].mask.numpy())),
                           training=False)
        jeval.update(b["image_id"], jax.tree.map(np.asarray, jpost(
            out["pred_logits"], out["pred_boxes"], jnp.asarray(b["orig_sizes"]))))
    want = jeval.summarize()
    assert set(got) == set(want) and "mAP" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


# ---------------------------------------------------------------------------
# the CLI on synthetic data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def det_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_det_train")
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(8):
        w, h = 100 + 4 * (i % 3), 80
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(root / f"img_{i}.jpg")
        images.append({"id": i, "file_name": f"img_{i}.jpg", "height": h, "width": w})
        for j in range(2):
            anns.append({"id": 10 * i + j, "image_id": i, "category_id": 1 + (i + j) % 4,
                         "bbox": [5 + 10 * j, 5, 30, 40], "area": 1200})
    ann_file = root / "ann.json"
    json.dump({"images": images, "annotations": anns}, open(ann_file, "w"))
    return str(root), str(ann_file)


DET_OVERRIDES = [
    "exp.device=cpu", "model.backbone=swin_test", "model.d_model=32",
    "model.detector.d_model=32", "model.detector.dim_feedforward=64",
    "model.detector.num_heads=4", "model.detector.num_layers=2",
    "model.detector.num_levels=2", "model.detector.num_points=2",
    "model.detector.num_queries=6", "model.detector.num_classes=8", "model.num_classes=8",
    "dataset.scales=[48]", "dataset.max_size=64", "dataset.fixed_bucket=[64, 64]",
    "dataset.max_boxes=8", "optimizer.batch_size=4", "optimizer.num_workers=2",
    "optimizer.lr=1e-3", "optimizer.lr_backbone=1e-3",
]


def test_cli_trains_validates_checkpoints_and_resumes(torch_one_thread, det_data, tmp_path,
                                                      monkeypatch, capsys):
    """``train_detector.main`` on the CPU: run A trains two epochs straight;
    run B trains one (with a validation set: an mAP summary and checkpoints),
    then resumes with ``exp.resume=true`` and trains the second.  Parameters,
    Adam moments and counters of the two are bit-equal."""
    from grit_tpu_torch import train_detector

    root, ann = det_data
    monkeypatch.chdir(tmp_path)
    base = DET_OVERRIDES + [f"dataset.roots.coco.ann_file={ann}",
                            f"dataset.roots.coco.img_root={root}",
                            f"dataset.valid_roots.coco.ann_file={ann}",
                            f"dataset.valid_roots.coco.img_root={root}"]
    train_detector.main(base + ["exp.name=detA", "optimizer.epochs=2"])
    trainer = train_detector.main(base + ["exp.name=detB", "optimizer.epochs=1"])
    out = capsys.readouterr().out
    assert "epoch 0 eval:" in out and "mAP" in out
    assert trainer.global_step == 2 and "mAP" in trainer.epoch_results
    assert [g["name"] for g in trainer.state.optimizer.param_groups] == [
        "head", "det_no_decay", "backbone_no_decay", "backbone_decay"]
    assert sorted(os.listdir("outputs/detB/checkpoints")) == ["detector_epoch_0",
                                                              "detector_last"]
    assert "epoch 0 results" in open("outputs/detB/detector_log.txt").read()
    train_detector.main(base + ["exp.name=detB", "optimizer.epochs=2", "exp.resume=true"])
    out = capsys.readouterr().out
    assert "resumed detector training from epoch 0" in out and "resume skipped" not in out
    a = tckpt.restore_checkpoint("outputs/detA", "detector_last")
    b = tckpt.restore_checkpoint("outputs/detB", "detector_last")
    assert a["epoch"] == b["epoch"] == 1 and a["global_steps"] == b["global_steps"] == 4
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for k, st in a["optimizer"]["state"].items():
        for part in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[part], b["optimizer"]["state"][k][part]), (k, part)
    # a resume with nothing to resume from starts afresh
    train_detector.main(base + ["exp.name=detC", "optimizer.epochs=0", "exp.resume=true"])
    assert "resume skipped" in capsys.readouterr().out


def test_cli_warm_start_trims_query_embed(torch_one_thread, det_data, tmp_path, monkeypatch,
                                          capsys):
    """``exp.checkpoint`` warm start (train_detector.py:134-153): a checkpoint
    trained with more queries loads with its ``query_embed`` rows trimmed when
    ``query_embed`` is in sp_names (it then trains in the sp group); the merge
    is strict=False with the counts printed."""
    from grit_tpu_torch import train_detector

    root, ann = det_data
    monkeypatch.chdir(tmp_path)
    base = DET_OVERRIDES + [f"dataset.roots.coco.ann_file={ann}",
                            f"dataset.roots.coco.img_root={root}"]
    train_detector.main(base + ["exp.name=donor", "optimizer.epochs=1",
                                "model.detector.num_queries=10"])
    donor = os.path.abspath("outputs/donor/checkpoints/detector_last")
    capsys.readouterr()
    trainer = train_detector.main(base + [
        "exp.name=trimmed", "optimizer.epochs=0", f"exp.checkpoint={donor}",
        'optimizer.sp_names=["attr_head", "query_embed"]'])
    out = capsys.readouterr().out
    assert "loaded" in out and "missing 0" in out
    donor_sd = tckpt.restore_checkpoint("outputs/donor", "detector_last")["state_dict"]
    qe = trainer.state.model.det_module.query_embed.weight
    assert donor_sd["det_module.query_embed.weight"].shape[0] == 10 and qe.shape[0] == 6
    assert torch.equal(qe.detach(), donor_sd["det_module.query_embed.weight"][:6])
    assert [g["name"] for g in trainer.state.optimizer.param_groups][-1] == "sp"
    # without the trim the rows do not fit: counted as missing, not loaded
    train_detector.main(base + ["exp.name=untrimmed", "optimizer.epochs=0",
                                f"exp.checkpoint={donor}"])
    assert "missing 1" in capsys.readouterr().out


def test_cli_and_model_factory_refuse_a_missing_card(monkeypatch, tmp_path):
    from grit_tpu_torch import train_detector
    from grit_tpu_torch.config import default_detection_config
    from grit_tpu_torch.detection.detector import build_detection_model

    assert not torch.cuda.is_available()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="exp.device=cpu"):
        train_detector.main([o for o in DET_OVERRIDES if o != "exp.device=cpu"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_detection_model(default_detection_config())
