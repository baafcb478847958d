"""The port's decode-layer tail (kernel K11's plain version) and SCST step
against the JAX package, on the CPU at fp32.

Tiny twins as in test_torch_models.py / test_torch_train.py; inputs come from
numpy seeds.  The JAX tail runs its Pallas kernel in interpret mode (as
tests/test_caption_model.py::TestFusedDecodeTail runs it) and its jnp mirror
``_ref``.  On CPU tensors the port's wrapper runs its plain version through
the same ``torch.autograd.Function`` the GPU path uses; the CUDA kernels are
compared with the plain version on the card by chip_smoke.py.

Tolerances are stated at each test; they come from f32 summation order.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grit_tpu.ops.decode_layer as jdl
from grit_tpu.engine import optim as joptim
from grit_tpu.engine import scst as jscst
from grit_tpu_torch import convert
from grit_tpu_torch.engine import scst as tscst
from grit_tpu_torch.models import cap_generator as tcap
from grit_tpu_torch.ops import decode_layer as tdl
from test_torch_models import (BOS, EOS, VOCAB, jax_captioner, jax_params, torch_captioner,
                               torch_one_thread, uint8_images)  # noqa: F401
from test_torch_train import (BACKBONE_LR, FROZEN_STAGES, jax_train_captioner, torch_state,
                              torch_train_captioner)

BEAM, STEPS = 5, 8
ATOL = 2e-5


def _interp():
    orig = jdl.pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    return mock.patch.object(jdl.pl, "pallas_call", interp)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def tail_inputs(masked: bool, seed=40, b=2, fold=3, d=32, d_ff=64, t1=7, t2=11):
    """x [B*fold, 1, D], K/V [B, T, D], bool masks [B, 1, 1, T] (the second
    image hides its last keys) or None, pad [B*fold, 1, 1] with a pad row, and
    the 24 weights in the JAX order and layout."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    x = f(b * fold, 1, d)
    kv = [f(b, t, d) for t in (t1, t1, t2, t2)]
    masks = [None, None]
    if masked:
        masks = [np.zeros((b, 1, 1, t), bool) for t in (t1, t2)]
        masks[0][1, ..., t1 - 2:] = True
        masks[1][1, ..., t2 - 4:] = True
    pad = np.ones((b * fold, 1, 1), np.float32)
    pad[2] = 0.0
    mat = lambda k, n: f(k, n, sc=k ** -0.5)  # noqa: E731
    ln = lambda: (1 + f(d, sc=0.1), f(d, sc=0.1))  # noqa: E731
    weights = (mat(d, d), f(d, sc=0.1), mat(d, d), f(d, sc=0.1), *ln(),
               mat(d, d), f(d, sc=0.1), mat(d, d), f(d, sc=0.1), *ln(),
               mat(d, d), mat(d, d), f(d, sc=0.1), mat(d, d), mat(d, d), f(d, sc=0.1),
               mat(d, d_ff), f(d_ff, sc=0.1), mat(d_ff, d), f(d, sc=0.1), *ln())
    return x, kv, masks, pad, weights, dict(fold=fold, n_heads=4)


def port_tail(x, kv, masks, pad, weights, kw, grad=False):
    t = lambda a: None if a is None else torch.from_numpy(a.copy()).requires_grad_(  # noqa: E731
        grad and a.dtype == np.float32)
    args = [t(x), t(kv[0]), t(kv[1]), t(masks[0]), t(kv[2]), t(kv[3]), t(masks[1]),
            torch.from_numpy(pad)]
    ws = [t(w) for w in weights]
    return tdl.fused_decode_layer_tail(*args, ws, **kw), args, ws


def jax_tail(x, kv, masks, pad, weights, kw):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return jdl.fused_decode_layer_tail(
        j(x), j(kv[0]), j(kv[1]), j(masks[0]), j(kv[2]), j(kv[3]), j(masks[1]), j(pad),
        tuple(j(w) for w in weights), **kw)


@pytest.mark.parametrize("masked", [True, False], ids=["masks", "no_masks"])
@pytest.mark.parametrize("ref", ["pallas_interpret", "jnp_ref"])
def test_decode_tail_plain_matches_jax(ref, masked):
    """The plain version of K11 against the Pallas kernel in interpret mode
    and against its jnp mirror; 2e-5 absolute on O(1) outputs."""
    x, kv, masks, pad, weights, kw = tail_inputs(masked)
    out, _, _ = port_tail(x, kv, masks, pad, weights, kw)
    if ref == "pallas_interpret":
        with _interp():
            want = np.asarray(jax_tail(x, kv, masks, pad, weights, kw))
    else:
        b = kv[0].shape[0]
        madd = [np.zeros((b, k.shape[1]), np.float32) if m is None
                else np.where(m.reshape(b, -1), np.float32(jdl.NEG), 0).astype(np.float32)
                for m, k in zip(masks, (kv[0], kv[2]))]
        want = np.asarray(jdl._ref(
            jnp.asarray(x[:, 0]), jnp.asarray(kv[0]), jnp.asarray(kv[1]), jnp.asarray(madd[0]),
            jnp.asarray(kv[2]), jnp.asarray(kv[3]), jnp.asarray(madd[1]),
            jnp.asarray(pad.reshape(-1, 1)), tuple(jnp.asarray(w) for w in weights),
            f=kw["fold"], h=kw["n_heads"], eps=1e-5))[:, None]
    assert out.shape == want.shape == x.shape
    assert np.abs(out.numpy() - want).max() <= ATOL
    assert (out.numpy()[2] == 0).all()          # the pad row


def test_decode_tail_gradient_matches_jax():
    """The recompute gradient (x, the four K/V tensors and all 24 weights)
    against jax.grad through the JAX op's own recompute backward; 1e-5 of
    each gradient's max."""
    x, kv, masks, pad, weights, kw = tail_inputs(True, seed=41)
    cot = np.random.default_rng(42).standard_normal(x.shape).astype(np.float32)

    def jloss(x, k1, v1, k2, v2, *ws):
        out = jdl.fused_decode_layer_tail(x, k1, v1, jnp.asarray(masks[0]), k2, v2,
                                          jnp.asarray(masks[1]), jnp.asarray(pad), ws, **kw)
        return (out * cot).sum()

    leaves = [x, *kv, *weights]
    with _interp():
        want = jax.grad(jloss, argnums=tuple(range(len(leaves))))(*map(jnp.asarray, leaves))
    out, args, ws = port_tail(x, kv, masks, pad, weights, kw, grad=True)
    (out * torch.from_numpy(cot)).sum().backward()
    got = [args[i].grad for i in (0, 1, 2, 4, 5)] + [w.grad for w in ws]
    for i, (g, r) in enumerate(zip(got, want)):
        assert _rel(g.numpy(), r) <= 1e-5, i


@pytest.fixture(scope="module")
def twins():
    from grit_tpu.utils.nested import ImageBatch as JaxBatch
    from grit_tpu_torch.utils.nested import ImageBatch

    model = torch_captioner()
    imgs, mask = uint8_images()
    return (model, jax_captioner(), {"params": jax_params(model)},
            ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)),
            JaxBatch(jnp.asarray(imgs), jnp.asarray(mask)))


def test_layer_tail_weights_cross_to_the_jax_op(twins):
    """``ParallelAttentionLayer.tail_weights`` / ``convert.decode_tail_weights``
    hand the JAX op the layer it came from: the jnp mirror on the converted
    24-tuple equals the port layer's module path; 2e-5."""
    model = twins[0]
    layer = model.cap_generator.layers[1]
    d = model.cap_generator.d_model
    x, kv, masks, pad, _, kw = tail_inputs(True, seed=43, d=d)
    t = torch.from_numpy
    with torch.no_grad():
        sa, mp = t(x), t(pad)
        enc1 = layer.vis_att1(sa, t(kv[0]), t(kv[1]), t(masks[0]), kv_projected=True,
                              kv_fold=kw["fold"]) * mp
        enc2 = layer.vis_att2(sa, t(kv[2]), t(kv[3]), t(masks[1]), kv_projected=True,
                              kv_fold=kw["fold"]) * mp
        want = layer._fuse(sa, enc1, enc2, mp).numpy()
    weights = convert.decode_tail_weights(layer)
    assert len(weights) == len(tdl.LAYER_WEIGHT_ORDER) == 24
    np.testing.assert_array_equal(weights[15], weights[12])     # the alpha bug: gate 2 = gate 1
    got = np.asarray(jdl._ref(
        jnp.asarray(x[:, 0]), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
        jnp.where(jnp.asarray(masks[0]).reshape(2, -1), jdl.NEG, 0.0).astype(jnp.float32),
        jnp.asarray(kv[2]), jnp.asarray(kv[3]),
        jnp.where(jnp.asarray(masks[1]).reshape(2, -1), jdl.NEG, 0.0).astype(jnp.float32),
        jnp.asarray(pad.reshape(-1, 1)), tuple(jnp.asarray(w) for w in weights),
        f=kw["fold"], h=kw["n_heads"], eps=1e-5))
    assert np.abs(got[:, None] - want).max() <= ATOL


def _decode(model, batch, eos, fused, monkeypatch):
    from grit_tpu_torch.decoding.beam_search import beam_search

    monkeypatch.setattr(tcap, "use_fused_tail",
                        (lambda layer, x: not layer.dropout_live()) if fused
                        else (lambda layer, x: False))
    with torch.no_grad():
        vis = model.compute_vis(batch)
        kv = model.precompute_vis_kv(vis)
        step = model.decode_step(torch.full((2 * BEAM, 1), BOS), 0, vis,
                                 model.init_cache(2 * BEAM, STEPS), vis_kv=kv, vis_fold=BEAM)[0]
        res = beam_search(
            lambda tok, t, v, c: model.decode_step(tok, t, v, c, vis_kv=kv, vis_fold=BEAM),
            model.init_cache(2 * BEAM, STEPS), vis, 2, BEAM, STEPS, BOS, eos, out_size=BEAM)
    return step.numpy(), res.sequences.numpy()


def test_decode_with_the_tail_matches_the_module_path(twins, monkeypatch):
    """A whole deterministic decode step (log-probs, 2e-5) and beam-5 captions
    of all beams (token for token) with the fused tail on, against the module
    path; with live dropout the layer keeps the module path."""
    model, batch = twins[0], twins[3]
    calls = []
    real = tdl.fused_decode_layer_tail
    monkeypatch.setattr(tdl, "fused_decode_layer_tail",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    step_on, seq_on = _decode(model, batch, VOCAB, True, monkeypatch)
    assert len(calls) == 2 * (1 + STEPS)                   # layers x (one step + the search)
    step_off, seq_off = _decode(model, batch, VOCAB, False, monkeypatch)
    assert len(calls) == 2 * (1 + STEPS)
    assert np.abs(step_on - step_off).max() <= ATOL
    np.testing.assert_array_equal(seq_on, seq_off)
    layer = model.cap_generator.layers[0]
    assert not layer.dropout_live() and not tcap.use_fused_tail(layer, torch.zeros(1))
    model.train()
    assert layer.dropout_live()
    for mod in layer.modules():
        if isinstance(mod, tcap.Dropout):
            mod.p = 0.0
    assert not layer.dropout_live()
    model.eval()
    for mod in layer.modules():
        if isinstance(mod, tcap.Dropout):
            mod.p = 0.1


@pytest.fixture(scope="module")
def generated(twins):
    """Beam-5 samples of both packages with an EOS that freezes beams early:
    the port's first chosen token."""
    model, jmodel, params, batch, jbatch = twins
    kw = dict(beam_size=BEAM, max_len=STEPS, bos_idx=BOS)
    first = tscst.make_generate_step(model, eos_idx=VOCAB, **kw)(batch, 2)[0]
    eos = int(first[0, 0, 0])
    seqs, logp = tscst.make_generate_step(model, eos_idx=eos, **kw)(batch, 2)
    jseqs, jlogp = jscst.make_generate_step(jmodel, eos_idx=eos, **kw)(params, jbatch, 2)
    return eos, seqs, logp, np.asarray(jseqs), np.asarray(jlogp)


def test_generate_step_matches_jax(twins, generated):
    """Sequences [B, beam, T] of all beams equal to the JAX package's, their
    per-step log-probs within 1e-5; the model is left in eval()."""
    eos, seqs, logp, jseqs, jlogp = generated
    assert seqs.shape == jseqs.shape == (2, BEAM, STEPS) and not twins[0].training
    assert (seqs.numpy() == eos).any() and not seqs.requires_grad
    np.testing.assert_array_equal(seqs.numpy(), jseqs)
    assert np.abs(logp.numpy() - jlogp).max() <= 1e-5


def test_sequence_log_probs_equal_the_search(twins, generated):
    """The teacher-forced re-scoring gives the search's own per-step
    log-probs, zero after the first EOS; 1e-5.  Against JAX's, 1e-5."""
    model, jmodel, params, batch, jbatch = twins
    eos, seqs, logp, jseqs, _ = generated
    with torch.no_grad():
        out = tscst.sequence_log_probs(model, batch, seqs, bos_idx=BOS, eos_idx=eos)
    assert out.shape == (2, BEAM, STEPS)
    assert np.abs(out.numpy() - logp.numpy()).max() <= 1e-5
    after = np.cumsum(seqs.numpy() == eos, -1) - (seqs.numpy() == eos) > 0
    assert after.any() and (out.numpy()[after] == 0).all()
    ref = jscst.sequence_log_probs(jmodel, params, jbatch, jnp.asarray(jseqs), bos_idx=BOS,
                                   eos_idx=eos)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5


def test_scst_update_matches_jax():
    """One SCST update with every dropout at 0, from the same weights, images,
    sequences and rewards, the second image a padding row (n_valid = 1):
    loss within 1e-5 relative; every gradient leaf within 1e-4 of its max
    (plus 1e-7 absolute); every updated parameter within 1e-4 of its max where
    the gradient is above 1e-6 and within twice the learning rate elsewhere
    (Adam's first step on a rounding-size gradient has either sign); frozen
    leaves bit for bit unchanged; as test_xe_step_matches_jax states its own."""
    from grit_tpu.engine import xe as jxe
    from grit_tpu.utils.nested import ImageBatch as JaxBatch
    from grit_tpu_torch.engine import optim as toptim
    from grit_tpu_torch.utils.nested import ImageBatch

    model_lr, t_len = 1e-4, 7
    model = torch_train_captioner()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params = {"params": jax.tree.map(np.copy, jax_params(model))}
    jmodel = jax_train_captioner()
    imgs, mask = uint8_images()
    rng = np.random.default_rng(50)
    seqs = rng.integers(4, VOCAB, (2, BEAM, t_len))
    seqs[0, 1, 4:] = [EOS, 0, 0]
    seqs[0, 3, 2:] = [EOS, 0, 0, 0, 0]
    rewards = np.zeros((2, BEAM), np.float32)
    rewards[0] = rng.random(BEAM) * 2
    jsamples = JaxBatch(jnp.asarray(imgs), jnp.asarray(mask))

    def jloss(p):
        logp = jscst.sequence_log_probs(jmodel, p, jsamples, jnp.asarray(seqs), bos_idx=BOS,
                                        eos_idx=EOS, rng=jax.random.PRNGKey(0))
        adv = rewards - rewards.mean(-1, keepdims=True)
        return (-logp.mean(-1) * adv).sum() / (1.0 * BEAM)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tx, labels = joptim.build_optimizer(params)
    freeze = joptim.frozen_mask(params, joptim.swin_frozen_stages_predicate(FROZEN_STAGES))
    jstep = jscst.make_scst_update_step(jmodel, tx, labels, bos_idx=BOS, eos_idx=EOS,
                                        model_lr=model_lr, backbone_lr=BACKBONE_LR, freeze=freeze)
    jstate = jxe.TrainState.create(jax.tree.map(jnp.array, params), tx)
    jstate, jmetrics = jax.block_until_ready(jstep(
        jstate, jsamples, jnp.asarray(seqs), jnp.asarray(rewards), np.float32(1.0),
        jax.random.PRNGKey(0)))

    state = torch_state(model)
    step = tscst.make_scst_update_step(bos_idx=BOS, eos_idx=EOS, model_lr=model_lr,
                                       backbone_lr=BACKBONE_LR)
    samples = ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask))
    state, metrics = step(state, samples, torch.from_numpy(seqs), rewards, 1.0)

    assert abs(float(metrics["loss"]) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for key in ("loss", "reward", "reward_baseline"):
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= 1e-5 * abs(float(jmetrics[key]))
    assert [g["lr"] for g in state.optimizer.param_groups] == [model_lr, BACKBONE_LR]

    ref_g = convert.params_to_state_dict(jax.tree.map(np.asarray, ref_grads["params"]))
    ref_p = convert.params_to_state_dict(jax.tree.map(np.asarray, jstate.params["params"]))
    tfreeze = toptim.frozen_mask(model, toptim.swin_frozen_stages_predicate(FROZEN_STAGES))
    n_grads = 0
    for name, p in model.named_parameters():
        if p.grad is None:
            assert not ref_g[name].any() or name.endswith("pos_emb.weight"), name
            big = np.zeros(ref_g[name].shape, bool)
        else:
            n_grads += 1
            err = np.abs(p.grad.numpy() - ref_g[name]).max()
            assert err <= 1e-4 * np.abs(ref_g[name]).max() + 1e-7, name
            big = np.abs(ref_g[name]) > 1e-6
        err = np.abs(p.detach().numpy() - ref_p[name])
        lr = BACKBONE_LR if "detector" in name else model_lr
        assert (err <= np.where(big, 1e-4 * np.abs(ref_p[name]).max(), 2 * lr)).all(), name
        if tfreeze[name] or name.endswith("pos_emb.weight"):
            assert torch.equal(p.detach(), before[name]), name
    assert n_grads > 150
