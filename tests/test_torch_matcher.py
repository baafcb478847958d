"""The port's set matcher against the JAX package's on-device solver, on the CPU.

``ops.lsa.lsa_plain`` (the plain version of the ``grit_lsa`` kernel, which CPU
tensors run) against ``jax.vmap(grit_tpu.detection.losses._device_lsa_single)``
and scipy; ``hungarian_match`` and the whole ``SetCriterion`` under
``match_impl="device"`` against the JAX package's under ``"device"`` and the
port's under ``"host"``; and the detection model built with
``with_box_refine=False``, which the JAX package accepts and never reads.

Tolerances: assignments exactly (on integer costs, which tie everywhere and
keep the f32 arithmetic exact, too); an assignment's total cost within 1e-5
of scipy's optimum (relative to max(1, |total|): the solver's potentials are
f32); losses 2e-5 and gradients 1e-5 of their max, as
tests/test_torch_detection.py holds the host path; the models' outputs 2e-5
of their max (f32 summation order), bit-equal between the port's two flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from grit_tpu.detection import losses as jlosses
from grit_tpu_torch.detection import losses as tlosses
from grit_tpu_torch.ops import lsa as lsa_ops
from test_torch_detection import (N_CLASSES, _j_targets, _map_outputs, _outputs, _rel,
                                  _t_targets, _targets)
from test_torch_models import torch_one_thread, uint8_images  # noqa: F401

_jax_lsa = jax.jit(jax.vmap(jlosses._device_lsa_single))


def _costs(kind: str, p: int, q: int, g: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "continuous":
        return (rng.standard_normal((p, q, g)) * 3).astype(np.float32)
    return rng.integers(0, 5, (p, q, g)).astype(np.float32)   # ties everywhere


def _check_plain(cost: np.ndarray, fills: np.ndarray) -> None:
    """``lsa_plain`` on ``cost`` [P, Q, G] with one fill a problem, all in one
    call: the assignments equal the JAX solver's, -1 past the fill, and each
    total cost is scipy's optimum on the valid sub-problem."""
    g = cost.shape[2]
    want = np.asarray(_jax_lsa(jnp.asarray(cost), jnp.asarray(fills, jnp.int32)))
    got = lsa_ops.lsa_plain(torch.from_numpy(cost), torch.from_numpy(fills)).numpy()
    assert got.dtype == np.int64 and got.shape == (len(fills), g)
    np.testing.assert_array_equal(got, want)
    for b, n in enumerate(fills):
        assert (got[b, n:] == -1).all()
        if n == 0:
            continue
        assert len(set(got[b, :n].tolist())) == n and (got[b, :n] >= 0).all()
        rows, cols = scipy_lsa(cost[b, :, :n].astype(np.float64))
        best = cost[b, rows, cols].astype(np.float64).sum()
        ours = cost[b, got[b, :n], np.arange(n)].astype(np.float64).sum()
        assert abs(ours - best) <= 1e-5 * max(1.0, abs(best)), (b, n, ours, best)


@pytest.mark.parametrize("kind", ["continuous", "integer"])
@pytest.mark.parametrize("q, g", [(150, 100), (20, 8), (12, 12), (50, 1)])
def test_lsa_plain_equals_the_jax_solver_and_scipy(q, g, kind):
    """Fills from 0 to G, one problem each (``_check_plain``)."""
    fills = np.unique(np.linspace(0, g, 5).astype(np.int64))
    _check_plain(_costs(kind, len(fills), q, g, seed=q * 1000 + g + (kind == "integer")), fills)


@pytest.mark.parametrize("kind", ["continuous", "integer"])
def test_lsa_plain_at_the_detector_fills(kind):
    """The padding-heavy problems a detector step solves: 150 queries x 100
    boxes at fills 1, 3, 7, 13 and 20 (``_check_plain``)."""
    fills = np.array([1, 3, 7, 13, 20])
    _check_plain(_costs(kind, len(fills), 150, 100, seed=17 + (kind == "integer")), fills)


@pytest.mark.parametrize("q, g", [(150, 100), (20, 8)])
def test_lsa_plain_counts_the_dijkstra_iterations(q, g):
    """``return_counts``: an all-zero problem of G rows (fill 0 or G) takes
    G(G+1)/2 Dijkstra iterations (row i takes i + 1: 5050 at 150 x 100) and
    one walk step a row; the assignments with counts are ``lsa_plain``'s
    without and the JAX solver's."""
    cost = np.concatenate([np.zeros((2, q, g), np.float32),
                           _costs("continuous", 2, q, g, seed=5),
                           _costs("integer", 2, q, g, seed=6)])
    fills = np.array([0, g, 1, g, g // 2, g])
    got, counts = lsa_ops.lsa_plain(torch.from_numpy(cost), torch.from_numpy(fills),
                                    return_counts=True)
    iterations, walk = counts["iterations"], counts["walk"]
    assert iterations.dtype == walk.dtype == torch.int64 and iterations.shape == (len(fills),)
    assert iterations[:2].tolist() == [g * (g + 1) // 2] * 2 and walk[:2].tolist() == [g] * 2
    assert (iterations >= g).all() and (walk >= g).all()
    assert torch.equal(got, lsa_ops.lsa_plain(torch.from_numpy(cost), torch.from_numpy(fills)))
    want = np.asarray(_jax_lsa(jnp.asarray(cost), jnp.asarray(fills, jnp.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_linear_sum_assignment_on_the_cpu_is_the_plain_version():
    """CPU tensors take ``lsa_plain`` (no launch counted; float64 costs cast
    to f32 as the JAX solver casts them); shapes the solver does not take
    raise."""
    cost = _costs("continuous", 3, 9, 5, seed=1).astype(np.float64)
    n_valid = torch.tensor([5, 0, 3])
    before = dict(lsa_ops.LAUNCHES)
    got = lsa_ops.linear_sum_assignment(torch.from_numpy(cost), n_valid)
    assert lsa_ops.LAUNCHES == before
    want = lsa_ops.lsa_plain(torch.from_numpy(cost.astype(np.float32)), n_valid)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="exceed"):
        lsa_ops.linear_sum_assignment(torch.zeros(2, 3, 4), torch.tensor([1, 1]))
    with pytest.raises(ValueError, match="n_valid"):
        lsa_ops.linear_sum_assignment(torch.zeros(2, 5, 4), torch.tensor([1]))
    # the detector step's problem fits a block: 150 queries x 100 boxes of f32 costs
    assert lsa_ops.smem_bytes(150, 100) == 4 * (15000 + 32)
    assert lsa_ops.smem_bytes(150, 100) <= lsa_ops.SMEM_LIMIT < lsa_ops.smem_bytes(400, 200)


def test_hungarian_match_device_equals_jax_device():
    """``impl="device"`` over stacked levels equals the JAX package's
    ``hungarian_match(impl="device")`` level by level, and (no tie here) the
    port's host path; on CPU tensors ``"auto"`` takes the host path."""
    rng = np.random.default_rng(17)
    b, q, g, levels = 4, 30, 12, 3
    tg = _targets(rng, b, g, [12, 5, 0, 1])
    out = _outputs(rng, b, q, levels)
    per_level = [out] + out["aux_outputs"]
    t = _t_targets(tg)
    logits = torch.from_numpy(np.stack([lv["pred_logits"] for lv in per_level]))
    boxes = torch.from_numpy(np.stack([lv["pred_boxes"] for lv in per_level]))
    dev = tlosses.hungarian_match(logits, boxes, t["labels"], t["boxes"], t["valid"],
                                  impl="device")
    assert dev.shape == (levels, b, g) and dev.dtype == torch.int64
    for lvl, got in zip(per_level, dev):
        want = np.asarray(jlosses.hungarian_match(
            lvl["pred_logits"], lvl["pred_boxes"], tg["labels"], tg["boxes"], tg["valid"],
            impl="device"))
        np.testing.assert_array_equal(got.numpy(), want)
    host = tlosses.hungarian_match(logits, boxes, t["labels"], t["boxes"], t["valid"],
                                   impl="host")
    auto = tlosses.hungarian_match(logits, boxes, t["labels"], t["boxes"], t["valid"])
    assert torch.equal(dev, host) and torch.equal(auto, host)
    assert (dev[:, 2] == -1).all() and (dev[:, 1, 5:] == -1).all() and (dev[:, 0] >= 0).all()


@pytest.mark.parametrize("attrs", [False, True])
def test_set_criterion_device_matches_jax_device_and_host(attrs):
    """The whole criterion under ``"device"``: every named loss, the total and
    the gradient of the total to every prediction equal the JAX criterion's
    under ``"device"`` and the port's own under ``"host"``."""
    rng = np.random.default_rng(18)
    b, q, g, levels = 3, 10, 4, 3
    tg = _targets(rng, b, g, [3, 4, 0], attrs)
    out = _outputs(rng, b, q, levels, attrs)
    jcrit = jlosses.SetCriterion(N_CLASSES, match_impl="device")

    def jtotal(o):
        losses = jcrit(o, _j_targets(tg))
        return jcrit.total_loss(losses), losses

    (jtot, jl), jgrads = jax.value_and_grad(jtotal, has_aux=True)(_map_outputs(out, jnp.asarray))
    flat_j = [jgrads[k] for k in sorted(jgrads) if k != "aux_outputs"] + [
        a[k] for a in jgrads["aux_outputs"] for k in sorted(a)]
    results = {}
    for impl in ("device", "host"):
        crit = tlosses.SetCriterion(N_CLASSES, match_impl=impl)
        tout = _map_outputs(out, lambda v: torch.from_numpy(v).requires_grad_())
        tl = crit(tout, _t_targets(tg))
        ttot = crit.total_loss(tl)
        ttot.backward()
        assert set(tl) == set(jl) and ("loss_attr" in tl) == attrs
        for k in tl:
            want = float(jl[k])
            assert abs(float(tl[k].detach()) - want) <= 2e-5 * max(1.0, abs(want)), k
        assert abs(float(ttot.detach()) - float(jtot)) <= 2e-5 * abs(float(jtot))
        flat_t = [tout[k] for k in sorted(tout) if k != "aux_outputs"] + [
            a[k] for a in tout["aux_outputs"] for k in sorted(a)]
        for tt, jg in zip(flat_t, flat_j):
            assert _rel(tt.grad.numpy(), jg) <= 1e-5
        results[impl] = ({k: float(v.detach()) for k, v in tl.items()},
                         [tt.grad.clone() for tt in flat_t])
    assert results["device"][0] == results["host"][0]
    assert all(torch.equal(x, y) for x, y in zip(results["device"][1], results["host"][1]))


DET_MODEL = ["model.backbone=swin_test", "model.detector.d_model=32",
             "model.detector.dim_feedforward=64", "model.detector.num_heads=4",
             "model.detector.num_layers=2", "model.detector.num_levels=2",
             "model.detector.num_points=2", "model.detector.num_queries=6",
             "model.detector.num_classes=8"]


def test_detection_model_without_box_refine_is_the_refining_model(torch_one_thread):
    """``with_box_refine=False`` builds (the port raised before), the same
    parameters and outputs as ``True`` bit for bit, and the JAX package's
    model with the same flag computes the same from converted weights."""
    from grit_tpu import config as jconfig
    from grit_tpu.detection.detector import build_detection_model as jbuild
    from grit_tpu.utils.nested import ImageBatch as JaxBatch
    from grit_tpu_torch import config as tconfig
    from grit_tpu_torch import convert
    from grit_tpu_torch.detection.detector import build_detection_model
    from grit_tpu_torch.utils.nested import ImageBatch

    imgs, mask = uint8_images()
    outs, sds = {}, {}
    for flag in ("false", "true"):
        cfg = tconfig.default_detection_config().apply_overrides(
            DET_MODEL + [f"model.detector.with_box_refine={flag}"])
        assert bool(cfg.model.detector.with_box_refine) == (flag == "true")
        model, crit = build_detection_model(cfg, device="cpu", seed=0)
        assert crit.cost["impl"] == "auto"
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():   # every norm matters: no all-zero padded rows
            for mod in model.modules():
                if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                    mod.weight.add_(torch.randn(mod.weight.shape, generator=g) * 0.3)
                    mod.bias.add_(torch.randn(mod.bias.shape, generator=g) * 0.3)
        model.eval()
        with torch.no_grad():
            outs[flag] = model(ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)))
        sds[flag] = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    assert sds["false"].keys() == sds["true"].keys()
    assert all(np.array_equal(sds["false"][k], sds["true"][k]) for k in sds["true"])
    for key in ("pred_logits", "pred_boxes"):
        assert torch.equal(outs["false"][key], outs["true"][key]), key

    jcfg = jconfig.default_detection_config().apply_overrides(
        DET_MODEL + ["model.detector.with_box_refine=false"])
    jmodel, _ = jbuild(jcfg)
    assert jmodel.det_module.with_box_refine is False
    jout = jax.jit(lambda p, im: jmodel.apply(p, im, training=False, deterministic=True))(
        {"params": convert.state_dict_to_params(sds["false"])},
        JaxBatch(jnp.asarray(imgs), jnp.asarray(mask)))
    assert _rel(outs["false"]["pred_logits"].numpy(), jout["pred_logits"]) <= 2e-5
    boxes = outs["false"]["pred_boxes"].numpy()
    assert np.abs(boxes - np.asarray(jout["pred_boxes"])).max() <= 2e-5
