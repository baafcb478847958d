"""The port's detection modules against the JAX package, on the CPU at fp32.

Inputs come from numpy seeds and go through the JAX function and its
counterpart in ``grit_tpu_torch``: box utilities, the losses, the Hungarian
matcher (both through scipy on the host; the device solver in
tests/test_torch_matcher.py), the set criterion with aux levels
and attributes, post-processing, the detection head and the whole detection
model from converted weights; the host modules the port copied (datasets,
transforms, loader, mAP evaluator, hooks) are held equal to the originals.

Tolerances: outputs 2e-5 of their max, gradients 1e-5 of each gradient's max
(f32 summation order); assignments, copied host modules and mAP exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from grit_tpu.detection import losses as jlosses
from grit_tpu.detection.postprocess import postprocess as jpostprocess
from grit_tpu.utils import boxes as jboxes
from grit_tpu_torch import convert
from grit_tpu_torch.detection import losses as tlosses
from grit_tpu_torch.detection.postprocess import postprocess as tpostprocess
from grit_tpu_torch.utils import boxes as tboxes
from test_torch_models import DET, SWIN, D, torch_one_thread, uint8_images  # noqa: F401

N_CLASSES = DET["num_classes"]
N_ATTR = 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _boxes(rng, *lead):
    """Random valid cxcywh boxes in [0, 1]."""
    cxcy = rng.uniform(0.2, 0.8, (*lead, 2))
    wh = rng.uniform(0.05, 0.35, (*lead, 2))
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def _box_case(name):
    rng = np.random.default_rng(3)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    axy = np.array(jboxes.box_cxcywh_to_xyxy(a))
    bxy = np.array(jboxes.box_cxcywh_to_xyxy(b))
    if name == "box_cxcywh_to_xyxy":
        return tboxes.box_cxcywh_to_xyxy(torch.from_numpy(a)), axy
    if name == "box_xyxy_to_cxcywh":
        return tboxes.box_xyxy_to_cxcywh(torch.from_numpy(axy)), jboxes.box_xyxy_to_cxcywh(axy)
    if name == "box_iou":
        return (torch.stack(tboxes.box_iou(torch.from_numpy(axy), torch.from_numpy(bxy))),
                np.stack(jboxes.box_iou(axy, bxy)))
    if name == "generalized_box_iou":
        return (tboxes.generalized_box_iou(torch.from_numpy(axy), torch.from_numpy(bxy)),
                jboxes.generalized_box_iou(axy, bxy))
    if name == "masks_to_boxes":
        masks = np.zeros((3, 9, 11), bool)
        masks[0, 2:5, 3:9] = True
        masks[1, 8, 0] = True          # masks[2] stays empty: a zero box
        return tboxes.masks_to_boxes(torch.from_numpy(masks)), jboxes.masks_to_boxes(masks)
    x = rng.uniform(-0.1, 1.1, (4, 6)).astype(np.float32)
    x[0, :2] = (0.0, 1.0)
    return tboxes.inverse_sigmoid(torch.from_numpy(x)), jboxes.inverse_sigmoid(x)


@pytest.mark.parametrize("name", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_iou",
                                  "generalized_box_iou", "masks_to_boxes", "inverse_sigmoid"])
def test_box_utilities_match_jax(name):
    got, want = _box_case(name)
    assert _rel(got.numpy(), want) <= 2e-6, name


def test_generalized_box_iou_batches_over_leading_axes():
    """The port's pairwise IoU takes leading batch axes (the criterion stacks
    the prediction levels): each slice equals the unbatched call."""
    rng = np.random.default_rng(4)
    a = tboxes.box_cxcywh_to_xyxy(torch.from_numpy(_boxes(rng, 2, 3, 6)))
    b = tboxes.box_cxcywh_to_xyxy(torch.from_numpy(_boxes(rng, 2, 3, 4)))
    full = tboxes.generalized_box_iou(a, b)
    assert full.shape == (2, 3, 6, 4)
    for i in range(2):
        for j in range(3):
            assert torch.equal(full[i, j], tboxes.generalized_box_iou(a[i, j], b[i, j]))


# ---------------------------------------------------------------------------
# losses and matching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.25, -1.0])
def test_sigmoid_focal_loss_matches_jax(alpha):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 6, N_CLASSES)) * 3).astype(np.float32)
    tgt = (rng.uniform(size=logits.shape) < 0.1).astype(np.float32)
    got = tlosses.sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(tgt), alpha)
    assert _rel(got.numpy(), jlosses.sigmoid_focal_loss(logits, tgt, alpha)) <= 2e-5


def test_dice_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 5, 7)).astype(np.float32)
    tgt = (rng.uniform(size=logits.shape) < 0.4).astype(np.float32)
    got = tlosses.dice_loss(torch.from_numpy(logits), torch.from_numpy(tgt), 3.0)
    assert _rel(got.numpy(), jlosses.dice_loss(logits, tgt, 3.0)) <= 2e-6
    cls = rng.standard_normal((9, N_CLASSES)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, 9)
    for k in (1, 3):
        got = tlosses.accuracy(torch.from_numpy(cls), torch.from_numpy(labels), k)
        assert abs(float(got) - float(jlosses.accuracy(cls, labels, k))) <= 1e-5
    assert float(tlosses.accuracy(torch.zeros(0, 4), torch.zeros(0, dtype=torch.long))) == 0.0


def _targets(rng, b, g, n_valid, attrs=False):
    tg = {"labels": rng.integers(0, N_CLASSES, (b, g)).astype(np.int32),
          "boxes": _boxes(rng, b, g),
          "valid": np.arange(g)[None, :] < np.asarray(n_valid)[:, None]}
    tg["labels"][~tg["valid"]] = 0
    tg["boxes"][~tg["valid"]] = 0.0
    if attrs:
        tg["attributes"] = (rng.uniform(size=(b, g, N_ATTR)) < 0.3).astype(np.float32)
        tg["has_attr"] = np.asarray([True] * (b - 1) + [False])
    return tg


def _t_targets(tg):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tg.items()}


def _j_targets(tg):
    return {k: jnp.asarray(v) for k, v in tg.items()}


def _outputs(rng, b, q, levels, attrs=False):
    def level():
        return {"pred_logits": (rng.standard_normal((b, q, N_CLASSES)) * 2).astype(np.float32),
                "pred_boxes": _boxes(rng, b, q)}
    out = level()
    out["aux_outputs"] = [level() for _ in range(levels - 1)]
    if attrs:
        out["attr_logits"] = rng.standard_normal((b, q, N_ATTR)).astype(np.float32)
    return out


def _map_outputs(out, fn):
    res = {k: fn(v) for k, v in out.items() if k != "aux_outputs"}
    res["aux_outputs"] = [{k: fn(v) for k, v in a.items()} for a in out["aux_outputs"]]
    return res


def test_hungarian_match_equals_jax_and_batches_levels():
    """The assignments equal the JAX package's host solver's, the cost
    matrices agree to 2e-5, an image without boxes and padding columns give
    -1, and the stacked call over levels equals the per-level calls."""
    rng = np.random.default_rng(7)
    b, q, g, levels = 3, 10, 4, 3
    tg = _targets(rng, b, g, [4, 2, 0])
    out = _outputs(rng, b, q, levels)
    per_level = [out] + out["aux_outputs"]
    t = _t_targets(tg)
    assigns = []
    for lvl in per_level:
        want = np.asarray(jlosses.hungarian_match(
            lvl["pred_logits"], lvl["pred_boxes"], tg["labels"], tg["boxes"], tg["valid"],
            impl="host"))
        got = tlosses.hungarian_match(torch.from_numpy(lvl["pred_logits"]),
                                      torch.from_numpy(lvl["pred_boxes"]), t["labels"],
                                      t["boxes"], t["valid"])
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got[2] == -1).all() and (got[1, 2:] == -1).all() and (got[0] >= 0).all()
        assigns.append(got)
    stacked = tlosses.hungarian_match(
        torch.from_numpy(np.stack([lv["pred_logits"] for lv in per_level])),
        torch.from_numpy(np.stack([lv["pred_boxes"] for lv in per_level])),
        t["labels"], t["boxes"], t["valid"])
    assert torch.equal(stacked, torch.stack(assigns))


def test_device_matcher_is_not_ported():
    """``match_impl``: the name is kept from when the port refused the device
    solver; now ``"device"`` is accepted (tests/test_torch_matcher.py holds
    it against the JAX package's) and an unknown solver still raises."""
    crit = tlosses.SetCriterion(N_CLASSES, match_impl="device")
    assert crit.cost["impl"] == "device"
    with pytest.raises(ValueError):
        tlosses.SetCriterion(N_CLASSES, match_impl="gpu")
    with pytest.raises(ValueError):
        tlosses.hungarian_match(torch.zeros(1, 3, N_CLASSES), torch.zeros(1, 3, 4),
                                torch.zeros(1, 2, dtype=torch.long), torch.zeros(1, 2, 4),
                                torch.zeros(1, 2, dtype=torch.bool), impl="gpu")


@pytest.mark.parametrize("attrs", [False, True])
def test_set_criterion_matches_jax(attrs):
    """Every named loss (final and aux levels, attributes), the total, and
    the gradient of the total to every prediction, with the assignments equal
    in both packages."""
    rng = np.random.default_rng(8)
    b, q, g, levels = 3, 10, 4, 3
    tg = _targets(rng, b, g, [3, 4, 0], attrs)
    out = _outputs(rng, b, q, levels, attrs)
    jcrit = jlosses.SetCriterion(N_CLASSES, match_impl="host")
    tcrit = tlosses.SetCriterion(N_CLASSES)

    def jtotal(o):
        losses = jcrit(o, _j_targets(tg))
        return jcrit.total_loss(losses), losses

    (jtot, jl), jgrads = jax.value_and_grad(jtotal, has_aux=True)(_map_outputs(out, jnp.asarray))
    tout = _map_outputs(out, lambda v: torch.from_numpy(v).requires_grad_())
    tl = tcrit(tout, _t_targets(tg))
    ttot = tcrit.total_loss(tl)
    ttot.backward()
    assert set(tl) == set(jl) and ("loss_attr" in tl) == attrs
    for k in tl:
        assert abs(float(tl[k].detach()) - float(jl[k])) <= 2e-5 * max(1.0, abs(float(jl[k]))), k
    assert abs(float(ttot.detach()) - float(jtot)) <= 2e-5 * abs(float(jtot))
    flat_t = [tout[k] for k in sorted(tout) if k != "aux_outputs"] + [
        a[k] for a in tout["aux_outputs"] for k in sorted(a)]
    flat_j = [jgrads[k] for k in sorted(jgrads) if k != "aux_outputs"] + [
        a[k] for a in jgrads["aux_outputs"] for k in sorted(a)]
    for t, jg in zip(flat_t, flat_j):
        assert _rel(t.grad.numpy(), jg) <= 1e-5


def test_criterion_takes_given_assignments():
    """``assigns`` replaces the matching: feeding the criterion's own
    assignments back gives the same losses, other assignments other losses."""
    rng = np.random.default_rng(9)
    tg = _t_targets(_targets(rng, 2, 3, [3, 2]))
    out = _map_outputs(_outputs(rng, 2, 8, 2), torch.from_numpy)
    crit = tlosses.SetCriterion(N_CLASSES)
    assigns = crit.match_levels(out, tg)
    assert assigns.shape == (2, 2, 3)
    base = crit(out, tg)
    again = crit(out, tg, assigns=assigns)
    assert all(torch.equal(base[k], again[k]) for k in base)
    rolled = torch.where(assigns >= 0, (assigns + 1) % 8, assigns)
    assert float(crit(out, tg, assigns=rolled)["loss_bbox"]) != float(base["loss_bbox"])


def test_postprocess_matches_jax():
    rng = np.random.default_rng(10)
    logits = (rng.standard_normal((2, 30, N_CLASSES)) * 2).astype(np.float32)
    boxes = _boxes(rng, 2, 30)
    sizes = np.asarray([[480, 640], [333, 500]], np.int32)
    want = jpostprocess(logits, boxes, sizes)
    got = tpostprocess(torch.from_numpy(logits), torch.from_numpy(boxes), torch.from_numpy(sizes))
    assert got["scores"].shape == (2, 100)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert _rel(got["scores"].numpy(), want["scores"]) <= 2e-6
    assert _rel(got["boxes"].numpy(), want["boxes"]) <= 2e-6
    small = tpostprocess(torch.from_numpy(logits[:, :5]), torch.from_numpy(boxes[:, :5]),
                         torch.from_numpy(sizes))
    assert small["scores"].shape == (2, 5 * N_CLASSES)


# ---------------------------------------------------------------------------
# the detection head and the whole detection model
# ---------------------------------------------------------------------------

def torch_detector(seed=0, attrs=True, dropout=0.0, **swin_kw):
    """A tiny port detector in train(): seeded weights with the norms, the
    MSDA projections and the heads' last layers perturbed, so that every
    parameter matters and window-padding rows are no zero vectors."""
    from grit_tpu_torch.detection.detector import DetectionDetector
    from grit_tpu_torch.models.captioner import init_weights
    from grit_tpu_torch.models.det_module import DetectionModule
    from grit_tpu_torch.models.swin import SwinTransformer

    model = DetectionDetector(SwinTransformer(**SWIN, **swin_kw),
                              DetectionModule(**DET, dropout=dropout), hidden_dim=D,
                              has_attr_head=attrs, num_attr_classes=N_ATTR,
                              num_od_classes=N_CLASSES)
    init_weights(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "sampling_offsets.weight" in name or "attention_weights.weight" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(torch.randn(mod.weight.shape, generator=g) * 0.3)
                mod.bias.add_(torch.randn(mod.bias.shape, generator=g) * 0.3)
    return model.train()


def jax_detector(attrs=True, dropout=0.0):
    from grit_tpu.detection.detector import DetectionDetector
    from grit_tpu.models.det_module import DetectionModule
    from grit_tpu.models.swin import SwinTransformer

    return DetectionDetector(
        backbone=SwinTransformer(drop_path_rate=0.0, fused_attn=False, **SWIN),
        det_module=DetectionModule(msda_impl="flat", name="det_module", dropout=dropout, **DET),
        hidden_dim=D, has_attr_head=attrs, num_attr_classes=N_ATTR, num_od_classes=N_CLASSES)


def det_params(model) -> dict:
    """The port detector's weights as a JAX params tree (copies)."""
    return {"params": convert.state_dict_to_params(
        {k: v.detach().numpy().copy() for k, v in model.state_dict().items()})}


def test_head_initialisation_is_the_jax_one():
    """``init_weights`` leaves the prediction heads where the JAX module's
    initialisers put them: every class bias at -log(99), the last bias of box
    head 0 at [0, 0, -2, -2], the other box heads' at 0; and the JAX model's
    freshly initialised tree has the same leaves as the port's."""
    from grit_tpu.utils.nested import ImageBatch as JaxBatch

    model = torch_detector()
    dm = model.det_module
    assert len(dm.class_embed) == len(dm.bbox_embed) == DET["num_layers"] + 1
    for head in dm.class_embed:
        assert torch.allclose(head.bias, torch.full_like(head.bias, -np.log(99.0)))
    assert dm.bbox_embed[0].layers[-1].bias.tolist() == [0.0, 0.0, -2.0, -2.0]
    assert not dm.bbox_embed[1].layers[-1].bias.any()
    imgs, mask = uint8_images()
    jinit = jax_detector().init(jax.random.PRNGKey(0), JaxBatch(jnp.asarray(imgs),
                                                                jnp.asarray(mask)), training=True)
    jsd = convert.params_to_state_dict(jax.tree.map(np.asarray, jinit["params"]))
    assert set(jsd) == set(model.state_dict())
    for i in range(DET["num_layers"] + 1):
        np.testing.assert_allclose(jsd[f"det_module.class_embed.{i}.bias"], -np.log(99.0),
                                   rtol=1e-6)
        np.testing.assert_array_equal(jsd[f"det_module.bbox_embed.{i}.layers.2.bias"],
                                      [0, 0, -2, -2] if i == 0 else [0, 0, 0, 0])
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == jsd[k].shape, k


def test_convert_carries_the_detection_model_both_ways():
    model = torch_detector()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = convert.state_dict_to_params(sd)
    assert {"backbone", "det_module", "attr_head", "input_proj_0_conv",
            "input_proj_1_norm"} <= set(tree)
    assert tree["attr_head"]["od_cls_embed"].shape == (N_CLASSES, D)
    assert tree["det_module"]["class_embed_2"]["kernel"].shape == (D, N_CLASSES)
    assert tree["det_module"]["bbox_embed_0"]["layers_2"]["bias"].shape == (4,)
    back = convert.params_to_state_dict(tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


@pytest.mark.parametrize("training", [True, False])
def test_detection_model_matches_jax(torch_one_thread, training):
    """The whole detection model from converted weights, dropouts off:
    training returns every level (final + aux) and the attribute logits,
    evaluation the last level; logits within 2e-5 of their max, boxes 2e-5."""
    from grit_tpu.utils.nested import ImageBatch as JaxBatch
    from grit_tpu_torch.utils.nested import ImageBatch

    model = torch_detector()
    imgs, mask = uint8_images()
    jout = jax.jit(lambda p, im: jax_detector().apply(
        p, im, training=training, deterministic=True))(
        det_params(model), JaxBatch(jnp.asarray(imgs), jnp.asarray(mask)))
    model.train(training)
    with torch.no_grad():
        tout = model(ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)))
    assert set(tout) == set(jout) and ("aux_outputs" in tout) == training
    levels = [(tout, jout)] + list(zip(tout.get("aux_outputs", []), jout.get("aux_outputs", [])))
    assert len(levels) == (DET["num_layers"] + 1 if training else 1)
    for t, j in levels:
        assert _rel(t["pred_logits"].numpy(), j["pred_logits"]) <= 2e-5
        assert np.abs(t["pred_boxes"].numpy() - np.asarray(j["pred_boxes"])).max() <= 2e-5
    assert _rel(tout["attr_logits"].numpy(), jout["attr_logits"]) <= 2e-5


# ---------------------------------------------------------------------------
# host modules the port copied: equal to the originals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def det_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_det")
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(10):
        w, h = 100 + 4 * (i % 3), 80
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(root / f"img_{i}.jpg")
        images.append({"id": i, "file_name": f"img_{i}.jpg", "height": h, "width": w})
        for j in range(1 + i % 3):
            anns.append({"id": 10 * i + j, "image_id": i, "category_id": 1 + (i + j) % 4,
                         "bbox": [5 + 10 * j, 5, 30, 40], "area": 1200,
                         "attribute_ids": [j, (i + j) % N_ATTR]})
    ann_file = root / "ann.json"
    json.dump({"images": images, "annotations": anns}, open(ann_file, "w"))
    return str(root), str(ann_file)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, (str, bytes)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _copied_datasets(det_root):
    from grit_tpu.detection import datasets as jds
    from grit_tpu_torch.config import Config
    from grit_tpu_torch.detection import datasets as tds

    root, ann = det_root
    for mod_kw in (dict(), dict(with_attributes=True, num_attr_classes=N_ATTR),
                   dict(exclude_image_ids={0, 3}), dict(overfit=True)):
        a, b = jds.DetectionDataset(ann, root, **mod_kw), tds.DetectionDataset(ann, root, **mod_kw)
        assert len(a) == len(b) and a.ids == b.ids
        for i in range(len(a)):
            (ia, ta), (ib, tb) = a[i], b[i]
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
            _assert_tree_equal(ta, tb)
    assert set(jds.DATASET_REGISTRY) == set(tds.DATASET_REGISTRY)
    cfg = Config({"dataset": {"overfit": False, "num_copies": {"coco": 2},
                              "roots": {"coco": {"ann_file": ann, "img_root": root},
                                        "vg": {"ann_file": ann, "img_root": root}}}})
    ca, cb = jds.build_train_dataset(cfg), tds.build_train_dataset(cfg)
    assert len(ca) == len(cb) == 30
    _assert_tree_equal(ca[25][1], cb[25][1])
    tgts = [a[i][1] for i in range(4)]
    _assert_tree_equal(jds.pad_targets(tgts, 2, N_ATTR), tds.pad_targets(tgts, 2, N_ATTR))
    _assert_tree_equal(jds.pad_targets(tgts, 6), tds.pad_targets(tgts, 6))


def _copied_transforms(det_root):
    import random

    from grit_tpu.detection import datasets as jds
    from grit_tpu.detection import det_transforms as jtr
    from grit_tpu_torch.detection import det_transforms as ttr

    root, ann = det_root
    ds = jds.DetectionDataset(ann, root, with_attributes=True, num_attr_classes=N_ATTR)
    for split, kw in (("train", dict(scales=[48, 56, 64], max_size=96)),
                      ("valid", dict(max_size=64))):
        for i in range(6):
            outs = []
            for mod in (jtr, ttr):
                random.seed(100 + i)
                mod.seed_item_rng(7 + i)
                img, tgt = ds[i]
                outs.append(mod.make_transforms(split, **kw)(img, tgt))
            np.testing.assert_array_equal(outs[0][0], outs[1][0])
            _assert_tree_equal(outs[0][1], outs[1][1])


def _copied_loader(det_root):
    from grit_tpu.detection import datasets as jds
    from grit_tpu.detection import det_transforms as jtr
    from grit_tpu.detection import loader as jld
    from grit_tpu_torch.detection import datasets as tds
    from grit_tpu_torch.detection import det_transforms as ttr
    from grit_tpu_torch.detection import loader as tld

    root, ann = det_root
    for mode, kw in (("train", dict(bucket_hw=(64, 64), max_boxes=4, seed=5, num_workers=3)),
                     ("valid", dict(num_workers=1))):
        tr = (dict(scales=[48], max_size=64) if mode == "train" else dict(max_size=64))
        a = jld.DetectionLoader(jds.DetectionDataset(ann, root), 3, mode=mode,
                                transform=jtr.make_transforms(mode, **tr), **kw)
        b = tld.DetectionLoader(tds.DetectionDataset(ann, root), 3, mode=mode,
                                transform=ttr.make_transforms(mode, **tr), **kw)
        a.set_epoch(2)
        b.set_epoch(2)
        assert len(a) == len(b) == (3 if mode == "train" else 4)
        for x, y in zip(a, b):
            assert isinstance(y["samples"].images, torch.Tensor)
            np.testing.assert_array_equal(np.asarray(x["samples"].images),
                                          y["samples"].images.numpy())
            np.testing.assert_array_equal(np.asarray(x["samples"].mask),
                                          y["samples"].mask.numpy())
            _assert_tree_equal({k: v for k, v in x.items() if k != "samples"},
                               {k: v for k, v in y.items() if k != "samples"})


def _copied_coco_eval(det_root):
    from grit_tpu.detection.coco_eval import CocoEvaluator as JEval
    from grit_tpu_torch.detection.coco_eval import CocoEvaluator as TEval

    rng = np.random.default_rng(11)
    gt, preds = {}, {}
    for img in range(6):
        n = int(rng.integers(1, 5))
        xy = rng.uniform(0, 60, (n, 2))
        gt[img] = {"boxes": np.concatenate([xy, xy + rng.uniform(8, 40, (n, 2))], 1),
                   "labels": rng.integers(1, 4, n)}
        k = 12
        jitter = gt[img]["boxes"][rng.integers(0, n, k)] + rng.normal(0, 4, (k, 4))
        preds[img] = {"scores": rng.uniform(size=k), "labels": rng.integers(1, 4, k),
                      "boxes": jitter}
    results = {k: np.stack([preds[i][k] for i in range(6)]) for k in ("scores", "labels", "boxes")}
    ja, ta = JEval(gt), TEval(gt)
    ja.update(list(range(6)), results)
    ta.update(list(range(6)), results)
    ta.synchronize_between_processes()      # one process: the identity
    sa, sb = ja.summarize(), ta.summarize()
    assert sa == sb and sa["mAP"] > 0


def _copied_hooks(det_root, tmp_path=None):
    from grit_tpu.detection import hooks as jh
    from grit_tpu.detection.solver import SolverBase as JSolver
    from grit_tpu_torch.detection import hooks as th
    from grit_tpu_torch.detection.solver import SolverBase as TSolver

    for mod, solver_cls in ((jh, JSolver), (th, TSolver)):
        assert {n for n in dir(mod) if n.endswith("Hook")} == {
            "Hook", "CheckpointHook", "TextLoggingHook", "ScalarWriterHook", "ProgressHook",
            "WarmupLRHook", "EpochLRHook"}
    seen = []
    for mod, solver_cls in ((jh, JSolver), (th, TSolver)):
        s = solver_cls([mod.WarmupLRHook(4, 0.1), mod.EpochLRHook([1, 3], 0.5),
                        mod.EpochLRHook([2], 0.1, attr="sp_epoch_lr_scale")])
        trace = []
        for epoch in range(4):
            s.epoch = epoch
            s.call_hooks("before_epoch")
            for _ in range(2):
                s.call_hooks("before_step")
                trace.append((s.lr_scale, s.epoch_lr_scale, s.sp_epoch_lr_scale))
                s.global_step += 1
        seen.append(trace)
    assert seen[0] == seen[1] and seen[1][0][0] == 0.1 and seen[1][-1] == (1.0, 0.25, 0.1)


@pytest.mark.parametrize("check", [_copied_datasets, _copied_transforms, _copied_loader,
                                   _copied_coco_eval, _copied_hooks],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_copied_detection_host_modules_equal_the_originals(check, det_root):
    """The port's own copies of the JAX package's host-only detection modules
    give what the originals give on the same files and seeds."""
    check(det_root)
