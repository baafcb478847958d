"""The port's Adam (kernel K12's plain version, ``engine.optim.Adam``) against
the JAX package, on the CPU at f32.

A small module with parameters in both optimizer groups and a frozen leaf
takes three steps on gradients made with numpy from a seed.  The JAX side
runs ``scale_by_adam_flat(impl="pallas")`` in interpret mode (as
tests/test_fused_adam.py runs it) or ``optax.scale_by_adam``, then
``add_decayed_weights``, ``apply_lr`` and ``apply_updates``, as
``grit_tpu.engine.xe`` chains them.  On CPU tensors the port's optimizer runs
the plain version of K12; the CUDA kernel is compared with it on the card by
chip_smoke.py.

Tolerance: 1e-6 of each leaf's max (for a parameter, its max before or after
the steps: a leaf that moved towards zero keeps its ulp) on parameters, mu and
nu: the same f32 operations in the same order (sqrt, division and XLA's fusion
may differ by an ulp).
"""

import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import grit_tpu.ops.fused_adam as jfa
from grit_tpu.engine import optim as joptim
from grit_tpu_torch import convert
from grit_tpu_torch.engine import optim as toptim
from grit_tpu_torch.ops import fused_adam as tfa
from test_torch_models import torch_one_thread  # noqa: F401

B1, B2 = 0.9, 0.99
MODEL_LR, BACKBONE_LR = 3e-3, 1e-3   # large enough for three steps to show in f32
TOL = 1e-6


def _interp():
    """Run the Pallas Adam kernel in interpret mode (tests/test_fused_adam.py)."""
    orig = jfa.pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    return mock.patch.object(jfa.pl, "pallas_call", interp)


def small_model(seed=0):
    """Leaves in both groups: 2-D, 1-D, a 1-element and an odd-sized one, and
    a LayerNorm that the freeze predicate names."""
    torch.manual_seed(seed)
    model = nn.ModuleDict({
        "cap": nn.ModuleDict({"fc": nn.Linear(53, 37), "one": nn.Linear(1, 1, bias=False)}),
        "detector": nn.ModuleDict({"proj": nn.Linear(7, 129), "norm": nn.LayerNorm(129)}),
    })
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape) * 0.5)
    return model


def frozen(name: str) -> bool:
    return "norm" in name


def grads_for(model, step):
    rng = np.random.default_rng(100 + step)
    return {n: (np.zeros(p.shape, np.float32) if frozen(n)
                else (rng.standard_normal(p.shape) * 0.1).astype(np.float32))
            for n, p in model.named_parameters()}


def port_optimizer(model, wd):
    return toptim.build_optimizer(model, model_lr=MODEL_LR, backbone_lr=BACKBONE_LR, beta_1=B1,
                                  beta_2=B2, weight_decay=wd,
                                  freeze=toptim.frozen_mask(model, frozen))


def port_steps(model, opt, steps):
    for step in steps:
        for n, p in model.named_parameters():
            p.grad = None if frozen(n) else torch.from_numpy(grads_for(model, step)[n])
        opt.step()


def _rel(a, b, scale=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), scale, 1e-30)


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no_decay", "decay"])
@pytest.mark.parametrize("impl", ["pallas", "optax"])
def test_adam_three_steps_match_jax(impl, wd):
    model = small_model()
    params = jax.tree.map(np.copy, convert.state_dict_to_params(model.state_dict()))
    adam = (jfa.scale_by_adam_flat(b1=B1, b2=B2, impl="pallas") if impl == "pallas"
            else optax.scale_by_adam(b1=B1, b2=B2))
    tx = optax.chain(adam, optax.add_decayed_weights(wd)) if wd else optax.chain(adam)
    labels = joptim.split_param_labels(params)
    freeze = joptim.frozen_mask(params, frozen)
    state = tx.init(params)
    with _interp():
        for step in (1, 2, 3):
            grads = convert.state_dict_to_params(grads_for(model, step))
            updates, state = tx.update(grads, state, params)
            updates = joptim.apply_lr(updates, labels, MODEL_LR, BACKBONE_LR, freeze)
            params = optax.apply_updates(params, updates)

    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = port_optimizer(model, wd)
    port_steps(model, opt, (1, 2, 3))

    ref = convert.params_to_state_dict(jax.tree.map(np.asarray, params))
    for name, p in model.named_parameters():
        assert _rel(p.detach().numpy(), ref[name], float(before[name].abs().max())) <= TOL, name
        assert torch.equal(p.detach(), before[name]) == frozen(name), name
    if impl == "pallas":
        spec = jfa.make_flat_spec(params)
        jmu, jnu = jfa.unflatten(state[0].mu, spec), jfa.unflatten(state[0].nu, spec)
    else:
        jmu, jnu = state[0].mu, state[0].nu
    mu, nu, count = convert.adam_state_to_trees(model, opt)
    assert count == int(state[0].count) == 3
    for ours, theirs in ((mu, jmu), (nu, jnu)):
        flat, flat_ref = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (ours, theirs))
        assert [p for p, _ in flat] == [p for p, _ in flat_ref]
        for (path, a), (_, b) in zip(flat, flat_ref):
            assert _rel(a, np.asarray(b)) <= TOL, path


def test_adam_state_crosses_to_jax_and_back():
    """Moments carried out as flax-layout trees and loaded into a fresh
    optimizer give the original's next step, bit for bit."""
    model = small_model()
    opt = port_optimizer(model, 0.01)
    port_steps(model, opt, (1, 2))
    twin = copy.deepcopy(model)
    twin_opt = port_optimizer(twin, 0.01)
    convert.adam_state_from_trees(twin, twin_opt, *convert.adam_state_to_trees(model, opt))
    port_steps(model, opt, (3,))
    port_steps(twin, twin_opt, (3,))
    for (n, a), (_, b) in zip(model.named_parameters(), twin.named_parameters()):
        assert torch.equal(a, b), n


def test_optimizer_state_dict_round_trip():
    """``state_dict`` -> ``load_state_dict`` into a freshly built optimizer:
    groups (names, learning rates, decay), step counts and moments come back,
    and the next step is bit-equal."""
    model = small_model()
    opt = port_optimizer(model, 0.01)
    port_steps(model, opt, (1, 2))
    opt.param_groups[0]["lr"] = 7e-4           # as the XE step sets it
    saved = copy.deepcopy(opt.state_dict())
    twin = copy.deepcopy(model)
    twin_opt = port_optimizer(twin, 0.0)
    twin_opt.load_state_dict(saved)
    assert [g["name"] for g in twin_opt.param_groups] == ["model", "backbone"]
    assert twin_opt.param_groups[0]["lr"] == 7e-4 and twin_opt.param_groups[1]["lr"] == BACKBONE_LR
    assert twin_opt.param_groups[0]["weight_decay"] == 0.01
    assert {int(s["step"]) for s in twin_opt.state.values()} == {2}
    port_steps(model, opt, (3,))
    port_steps(twin, twin_opt, (3,))
    for (n, a), (_, b) in zip(model.named_parameters(), twin.named_parameters()):
        assert torch.equal(a, b), n


def test_weight_decay_is_decoupled_and_none_gradients_are_skipped():
    """The decay is AdamW's (scaled by the learning rate, outside the
    moments), not Adam's L2 term: three steps agree with torch.optim.AdamW to
    1e-6, and differ from torch.optim.Adam(weight_decay=) by far more.  A leaf
    without a gradient keeps its value, its moments and its step count."""
    model = small_model()
    named = dict(model.named_parameters())
    kw = dict(lr=MODEL_LR, betas=(B1, B2), eps=1e-8, weight_decay=0.1)
    ours = toptim.Adam(list(copy.deepcopy(model).parameters()), **kw)
    adamw = torch.optim.AdamW(list(copy.deepcopy(model).parameters()), **kw)
    l2 = torch.optim.Adam(list(copy.deepcopy(model).parameters()), **kw)
    for step in (1, 2, 3):
        grads = grads_for(model, step)
        for opt in (ours, adamw, l2):
            for name, p in zip(named, opt.param_groups[0]["params"]):
                skip = opt is ours and step == 2 and name == "cap.one.weight"
                p.grad = None if skip else torch.from_numpy(grads[name].copy())
            opt.step()
    worst_l2 = 0.0
    for name, a, b, c in zip(named, ours.param_groups[0]["params"],
                             adamw.param_groups[0]["params"], l2.param_groups[0]["params"]):
        if name == "cap.one.weight":
            assert ours.state[a]["step"] == 2      # skipped once
            continue
        if not frozen(name):
            assert _rel(a.detach().numpy(), b.detach().numpy()) <= TOL, name
            worst_l2 = max(worst_l2, _rel(a.detach().numpy(), c.detach().numpy()))
    assert worst_l2 > 1e-3


def test_plain_update_matches_adam_math_of_the_jax_package():
    """One call of the plain version against ``_adam_math`` itself, on an odd
    sized leaf at step 5: mu and nu bit for bit in numpy terms, the update to
    1e-6."""
    rng = np.random.default_rng(7)
    g, mu, nu, p = (rng.standard_normal(1001).astype(np.float32) * s for s in (0.1, 0.05, 1, 1))
    nu = np.abs(nu) * 0.01
    s = tfa.adam_scalars(5, MODEL_LR, B1, B2, 1e-8, 0.0, 0.0)
    u, mu2, nu2 = jfa._adam_math(jnp.asarray(g), jnp.asarray(mu), jnp.asarray(nu),
                                 jnp.float32(s["c1"]), jnp.float32(s["c2"]), b1=B1, b2=B2,
                                 eps=1e-8, eps_root=0.0)
    tp, tg, tmu, tnu = (torch.from_numpy(a.copy()) for a in (p, g, mu, nu))
    tfa.adam_update_plain([tp], [tg], [tmu], [tnu], step=5, lr=MODEL_LR, b1=B1, b2=B2)
    assert _rel(tmu.numpy(), np.asarray(mu2)) <= TOL and _rel(tnu.numpy(), np.asarray(nu2)) <= TOL
    assert _rel(tp.numpy(), p - np.float32(MODEL_LR) * np.asarray(u)) <= TOL
    # the bias correction as optax computes it: 1 - decay ** count in f32
    count = optax.safe_increment(jnp.asarray(4, jnp.int32))
    assert abs(s["c1"] - float(1.0 - jnp.asarray(B1, jnp.float32) ** count)) <= 1e-7
