"""The port's XE training slice against the JAX package, on the CPU at fp32.

Tiny twins (Swin depths (2, 2), window 6, 2 levels; ``frozen_stages=2`` so
stage 1 is frozen and stage 2 trains with one unshifted and one shifted
block on a padded map).  Inputs come from numpy seeds.  The JAX side runs its
plain formulations (``_unfused``, ``_mlp_ref2``, ``ms_deform_attn_reference``,
``fused_attn=False``, ``msda_impl="flat"``), which its Pallas kernels are
tested against elsewhere.  On CPU tensors the port's kernel wrappers run
their plain versions, but through the same ``torch.autograd.Function``s
(K4's projections' backward, K2's recompute) that the GPU path uses; the
CUDA kernels themselves are compared with the plain versions on the card by
chip_smoke.py.

Tolerances are stated at each test; they come from f32 summation order.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.engine import optim as joptim
from grit_tpu.engine import xe as jxe
from grit_tpu.ops import msda as jmsda
from grit_tpu.ops import window as jwin
from grit_tpu.ops import window_attention as jwa
from grit_tpu_torch import convert
from grit_tpu_torch.engine import optim as toptim
from grit_tpu_torch.engine import xe as txe
from grit_tpu_torch.ops import msda as tmsda
from grit_tpu_torch.ops import window_attention as twa
from test_torch_models import (BOS, DET, MAXLEN, PAD, SWIN, VOCAB, D, jax_params,
                               torch_one_thread, uint8_images)  # noqa: F401

SCHED = dict(num_epochs=5, num_its_per_epoch=50, init_lr=1e-4, min_lr=1e-5, warmup_init_lr=1e-5)
BACKBONE_LR = 1e-5
FROZEN_STAGES = 2


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _rel(a, b):
    """max |a - b| as a share of max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# (a) K4 + K5: block_attention_train gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [0, 3])
def test_block_attention_gradients_match_jax(shift):
    """All six gradients (map, qkv and proj weights and biases, bias table) of
    the attention branch on a zero-padded map, against jax.grad of the same
    composition over ``_unfused``; 1e-5 of each gradient's max."""
    b, hp, wp, c, heads, win, real = 2, 12, 18, 16, 2, 6, (10, 14)
    n = win * win
    rng = np.random.default_rng(20)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    x = f(b, hp, wp, c)
    x[:, real[0]:] = 0
    x[:, :, real[1]:] = 0      # the LayerNorm'd map is zero on window padding
    args = dict(x=x, qkv_w=f(3 * c, c, sc=c ** -0.5), qkv_b=f(3 * c, sc=0.1),
                proj_w=f(c, c, sc=c ** -0.5), proj_b=f(c, sc=0.1),
                table=f((2 * win - 1) ** 2, heads))
    cot = f(b, hp, wp, c)
    idx = jwin.relative_position_index((win, win)).reshape(-1)
    mask = jwin.shifted_window_mask(hp, wp, win, shift) if shift else None

    def jbranch(x, qkv_w, qkv_b, proj_w, proj_b, table):
        xs = jnp.roll(x, (-shift, -shift), (1, 2))
        xw = jwin.window_partition(xs, win).reshape(b, -1, n, c)
        qkv = xw @ qkv_w.T + qkv_b
        bias = table[idx].reshape(n, n, heads).transpose(2, 0, 1)[None]
        if mask is not None:
            bias = bias + jnp.asarray(mask)[:, None]
        o = jwa._unfused(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias,
                         (c // heads) ** -0.5, heads)
        y = jwin.window_reverse((o @ proj_w.T + proj_b).reshape(-1, n, c), win, hp, wp)
        return (jnp.roll(y, (shift, shift), (1, 2)) * cot).sum()

    names = list(args)
    ref = jax.grad(jbranch, argnums=tuple(range(6)))(*[args[k] for k in names])
    leaves = {k: _t(v, grad=True) for k, v in args.items()}
    out = twa.block_attention_train(*[leaves[k] for k in names], num_heads=heads, window=win,
                                    shift=shift)
    (out * _t(cot)).sum().backward()
    for k, r in zip(names, ref):
        assert _rel(leaves[k].grad.numpy(), r) <= 1e-5, k

    # the forward pair of K4 and the hand-off to K5, against autograd of the plain version
    out2, ao = twa.block_attention(*[leaves[k].detach() for k in names], num_heads=heads,
                                   window=win, shift=shift, save_attn=True)
    assert torch.equal(out2, out.detach()) and ao.shape == (b * hp * wp, c)


def test_window_attention_bwd_plain_matches_manual_formula():
    """K5's plain version (autograd) against the formulas the kernel codes:
    dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)), dQ = scale dS K,
    dK = dS^T Q, dTable = scatter of dS summed over images and windows;
    1e-5 of each result's max."""
    b, hp, wp, c, heads, win, shift = 2, 12, 12, 64, 2, 6, 3
    n, d = win * win, 32
    rng = np.random.default_rng(21)
    qkv = _t(rng.standard_normal((b * hp * wp, 3 * c)).astype(np.float32) * 0.5)
    d_ao = _t(rng.standard_normal((b * hp * wp, c)).astype(np.float32))
    table = _t(rng.standard_normal(((2 * win - 1) ** 2, heads)).astype(np.float32))
    geo = dict(batch=b, hp=hp, wp=wp, num_heads=heads, window=win, shift=shift)
    dqkv, dtable = twa.window_attention_bwd(qkv, d_ao, table, **geo)

    def heads_of(t):
        return t.reshape(-1, n, heads, d).transpose(1, 2).double()

    q, k, v = (heads_of(qkv[:, i * c:(i + 1) * c]) for i in range(3))
    do = heads_of(d_ao)
    from grit_tpu_torch.ops.window import relative_position_index, shifted_window_mask
    idx = relative_position_index(win).reshape(-1)
    s = q @ k.transpose(-1, -2) + table.double()[idx].reshape(n, n, heads).permute(2, 0, 1)
    s = (s.reshape(b, -1, heads, n, n)
         + shifted_window_mask(hp, wp, win, shift)[None, :, None]).reshape(s.shape)
    p = torch.softmax(s, -1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))

    def rows(t):
        return t.transpose(1, 2).reshape(-1, c)

    want = torch.cat([rows(ds @ k) * d ** -0.5, rows(ds.transpose(-1, -2) @ q),
                      rows(p.transpose(-1, -2) @ do)], 1)
    want_table = torch.zeros_like(table, dtype=torch.float64).index_add_(
        0, idx, ds.sum(0).reshape(heads, n * n).t())
    assert _rel(dqkv.numpy(), want.numpy()) <= 1e-5
    assert _rel(dtable.numpy(), want_table.numpy()) <= 1e-5


def _stage_shapes(config, hw):
    """(padded map (Hp, Wp), heads) of each Swin-B stage at image size ``hw``:
    the map at H/4 .. H/32 (each merge rounds up), padded to the window."""
    from grit_tpu_torch.models.swin import BACKBONES
    bb = BACKBONES[config.model.backbone]
    win = bb["window"]
    out = []
    for i in range(len(bb["depths"])):
        h, w = (-(-s // (4 * 2 ** i)) for s in hw)
        out.append(((-(-h // win) * win, -(-w // win) * win), bb["num_heads"][i], win))
    return out


@pytest.mark.parametrize("run,stage", [("XE b16", 2), ("XE b16", 3), ("XE b16", 4),
                                       ("detector b4", 1), ("detector b4", 2),
                                       ("detector b4", 3), ("detector b4", 4)])
def test_bwd_batch_chunks_fill_the_card(run, stage):
    """The bf16 backward kernel's batch split at the stages that train in the
    b16 384x640 XE step and the b4 832x1344 detector step, on an H100's 132
    SMs: every launch has about two waves of blocks (or a block per window,
    head and image), and the partial bias gradient, a [nW, heads, N, N] slice
    a chunk, stays one slice a (window, head) where those fill the card and
    under one wave's worth more elsewhere."""
    from grit_tpu_torch.config import default_caption_config, default_detection_config
    sms = 132
    if run.startswith("XE"):
        config, batch = default_caption_config(), 16
        hw = tuple(config.dataset.transform_cfg.size)
    else:
        config, batch = default_detection_config(), 4
        hw = tuple(config.dataset.fixed_bucket)
    (hp, wp), heads, win = _stage_shapes(config, hw)[stage - 1]
    per_image = (hp // win) * (wp // win) * heads
    chunks = twa.bwd_batch_chunks(batch, per_image, sms)
    assert 1 <= chunks <= batch
    assert chunks * per_image >= min(batch * per_image, twa._BWD_WAVES * sms)
    if per_image >= twa._BWD_WAVES * sms:
        assert chunks == 1
    assert chunks * per_image < per_image + twa._BWD_WAVES * sms



@pytest.mark.parametrize("run,stage", [("XE b16", 3), ("XE b16", 4), ("detector b4", 1),
                                       ("detector b4", 2), ("detector b4", 3),
                                       ("detector b4", 4)])
def test_bwd_batch_chunks_fill_the_card_fp32(run, stage, monkeypatch):
    """The fp32 backward kernel (csrc/win_attn_f32.cu, one block an SM like
    the bf16 one) splits the batch as the bf16 kernel does: the wrapper's
    choice for an fp32 tensor on a card of 132 SMs is ``bwd_batch_chunks``'s,
    about two waves of blocks, and the b16 XE step's stage 4 (2 windows x 32
    heads an image) is no longer one launch of 64 blocks walking 16 images
    each."""
    from grit_tpu_torch.config import default_caption_config, default_detection_config
    sms = 132
    monkeypatch.setattr(twa, "_sm_count", lambda index: sms)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    if run.startswith("XE"):
        config, batch = default_caption_config(), 16
        hw = tuple(config.dataset.transform_cfg.size)
    else:
        config, batch = default_detection_config(), 4
        hw = tuple(config.dataset.fixed_bucket)
    (hp, wp), heads, win = _stage_shapes(config, hw)[stage - 1]
    per_image = (hp // win) * (wp // win) * heads
    chunks = twa._bwd_chunks(torch.empty(0, dtype=torch.float32), batch, per_image)
    assert chunks == twa.bwd_batch_chunks(batch, per_image, sms)
    assert chunks * per_image >= min(batch * per_image, twa._BWD_WAVES * sms)
    assert chunks * per_image < per_image + twa._BWD_WAVES * sms
    if run.startswith("XE") and stage == 4:
        assert per_image == 64 and chunks == 5

def test_backward_kernels_have_launch_counters():
    """``LAUNCHES`` counts the fp32 GEMM and each instantiation of the
    attention backward apart, and a CPU call (the plain version) counts no
    launch."""
    for key in ("gemm_f32", "gemm_bf16", "win_attn_bwd_bf16", "win_attn_bwd_f32"):
        assert twa.LAUNCHES[key] >= 0
    before = dict(twa.LAUNCHES)
    b, hp, wp, c, heads, win = 1, 6, 6, 64, 2, 6
    qkv = torch.randn(b * hp * wp, 3 * c)
    twa.window_attention_bwd(qkv, torch.randn(b * hp * wp, c),
                             torch.randn((2 * win - 1) ** 2, heads), batch=b, hp=hp, wp=wp,
                             num_heads=heads, window=win)
    assert twa.LAUNCHES == before


@pytest.mark.parametrize("window", [6, 12])
def test_table_grad_is_the_scatter_sum_in_a_fixed_order(window):
    """The bias gradient's scatter into the relative-position table (a gather
    by ``relative_position_gather`` and a sum) equals ``index_add_`` of the
    same values, every position of the N x N bias counted once, and is the
    same bit for bit on a second call."""
    from grit_tpu_torch.ops.window import relative_position_gather, relative_position_index
    n, heads = window * window, 3
    gather = relative_position_gather(window)
    pos = gather[gather < n * n]
    assert sorted(pos.tolist()) == list(range(n * n))
    ds = torch.from_numpy(np.random.default_rng(25).standard_normal((heads, n, n))
                          .astype(np.float32))
    idx = relative_position_index(window).reshape(-1)
    want = torch.zeros((2 * window - 1) ** 2, heads).index_add_(0, idx,
                                                                ds.reshape(heads, -1).t())
    got = twa._table_grad(ds, window)
    assert _rel(got.numpy(), want.numpy()) <= 1e-6
    assert torch.equal(got, twa._table_grad(ds, window))


# ---------------------------------------------------------------------------
# (b) K2: mlp gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residual", [True, False])
def test_mlp_gradients_match_jax(residual):
    """Gradients of all seven inputs against jax.grad of ``_mlp_ref2``, the
    recompute target of the Pallas kernel's own backward; 1e-5 of each max."""
    rows, c = 50, 32
    rng = np.random.default_rng(22)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    x, lw, lb = f(rows, c), 1 + f(c, sc=0.1), f(c, sc=0.1)
    w1, b1, w2, b2 = f(4 * c, c, sc=c ** -0.5), f(4 * c, sc=0.1), f(c, 4 * c, sc=0.5 / c), f(c)
    cot = f(rows, c)

    def jloss(x, lw, lb, w1t, b1, w2t, b2):
        return (jwa._mlp_ref2(x, lw, lb, w1t, b1, w2t, b2, 1e-5, residual) * cot).sum()

    ref = jax.grad(jloss, argnums=tuple(range(7)))(x, lw, lb, w1.T, b1, w2.T, b2)
    leaves = [_t(a, grad=True) for a in (x, lw, lb, w1, b1, w2, b2)]
    out = twa.mlp(*leaves, residual=residual)
    (out * _t(cot)).sum().backward()
    for i, (leaf, r) in enumerate(zip(leaves, ref)):
        r = np.asarray(r).T if i in (3, 5) else r
        assert _rel(leaf.grad.numpy(), r) <= 1e-5, i
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jwa._mlp_ref2(x, lw, lb, w1.T, b1, w2.T, b2, 1e-5, residual)), atol=1e-5)


# ---------------------------------------------------------------------------
# (c) K3 + K6: msda gradients
# ---------------------------------------------------------------------------

def test_msda_gradients_match_jax():
    """Gradients of value, locations and weights against
    jax.grad(ms_deform_attn_reference) on the pre-masked value, one image of
    the batch padded; 2e-5 of each gradient's max (the reference sums corners
    and points in another order)."""
    rng = np.random.default_rng(23)
    shapes = ((6, 8), (3, 4))
    n, lq, m, d, p = 2, 5, 2, 4, 3
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m * d)).astype(np.float32)
    loc = (rng.random((n, lq, m, len(shapes), p, 2)) * 1.3 - 0.15).astype(np.float32)
    attn = rng.random((n, lq, m, len(shapes), p)).astype(np.float32)
    attn /= attn.reshape(n, lq, m, -1).sum(-1)[..., None, None]
    real_hw = np.array([[h, w] for h, w in shapes] * n).reshape(n, len(shapes), 2)
    real_hw[1] = [[4, 5], [2, 3]]
    cot = rng.standard_normal((n, lq, m * d)).astype(np.float32)
    keep = np.zeros((n, s, 1), np.float32)
    for lid, ((h, w), st) in enumerate(zip(shapes, jmsda.level_start_index(shapes))):
        lv = np.zeros((n, h, w, 1), np.float32)
        for i in range(n):
            lv[i, :real_hw[i, lid, 0], :real_hw[i, lid, 1]] = 1
        keep[:, st:st + h * w] = lv.reshape(n, h * w, 1)

    def jloss(value, loc, attn):
        out = jmsda.ms_deform_attn_reference((value * keep).reshape(n, s, m, d), shapes, loc, attn)
        return (out * cot).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(value, loc, attn)
    leaves = [_t(a, grad=True) for a in (value, loc, attn)]
    out = tmsda.msda(leaves[0], shapes, leaves[1], leaves[2], _t(real_hw))
    (out * _t(cot)).sum().backward()
    for leaf, r, name in zip(leaves, ref, ("value", "locations", "weights")):
        assert _rel(leaf.grad.numpy(), r) <= 2e-5, name
    assert (leaves[0].grad.numpy() * (1 - keep) == 0).all()   # padding gets no gradient


# ---------------------------------------------------------------------------
# (c2) K8, K10a, K10b, K13b: gradients against the Pallas backward bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m_windows", ["one", "every"])
def test_window_attention_gradients_match_jax_kernel(m_windows):
    """K8: dq, dk, dv and the bias gradient in the bias's own shape (summed
    over the batch, and over windows for a one-window bias) against jax.grad
    of ``fused_window_attention``, whose backward is the Pallas ``_bwd_kernel``
    in interpret mode; 1e-5 of each gradient's max."""
    from test_torch_ops import interpret

    b, nw, heads, n, d = 3, 4, 2, 16, 8
    rng = np.random.default_rng(24)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = (f(b, nw, n, heads * d) for _ in range(3))
    bias = f(1 if m_windows == "one" else nw, heads, n, n)
    cot = f(b, nw, n, heads * d)
    with interpret(jwa):
        ref = jax.grad(lambda *a: (jwa.fused_window_attention(*a, 0.3, heads) * cot).sum(),
                       argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    leaves = [_t(a, grad=True) for a in (q, k, v, bias)]
    (twa.window_attention(*leaves, 0.3, heads) * _t(cot)).sum().backward()
    for leaf, r, name in zip(leaves, ref, ("q", "k", "v", "bias")):
        assert leaf.grad.shape == leaf.shape
        assert _rel(leaf.grad.numpy(), r) <= 1e-5, name


@pytest.mark.parametrize("op", ["ln_linear", "patch_merge", "layernorm_rows"])
def test_ln_kernels_gradients_match_jax(op):
    """K10a and K10b: the gradients of every input (the backward recomputes
    through the plain version) against jax.grad of ``fused_ln_linear`` /
    ``fused_layernorm`` in interpret mode, whose backwards recompute through
    their jnp mirrors; ``patch_merge`` on an odd map against the same
    composition behind the gather; 1e-5 of each gradient's max."""
    from test_torch_ops import interpret

    rng = np.random.default_rng(25)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    c, out_dim = 16, 24
    if op == "patch_merge":
        x, k_in = f(2, 7, 9, c), 4 * c
    else:
        x, k_in = f(2, 24, 4 * c) * 2 + 0.5, 4 * c
    lw, lb, w = 1 + f(k_in, sc=0.1), f(k_in, sc=0.1), f(out_dim, k_in, sc=0.125)

    def gather(x):
        x = jnp.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
        x = jnp.concatenate([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                             x[:, 1::2, 1::2]], -1)
        return x.reshape(2, -1, 4 * c)

    if op == "layernorm_rows":
        cot = f(*x.shape)
        jfn = lambda x, lw, lb: (jwa.fused_layernorm(x, lw, lb, eps=1e-5) * cot).sum()  # noqa: E731
        jargs, targs = (x, lw, lb), (x, lw, lb)
        tfn = lambda *a: twa.layernorm_rows(*a, eps=1e-5)  # noqa: E731
    else:
        merge = op == "patch_merge"
        cot = f(2, 4 * 5 if merge else 24, out_dim)
        jfn = lambda x, lw, lb, wt: (jwa.fused_ln_linear(  # noqa: E731
            gather(x) if merge else x, lw, lb, wt, eps=1e-5) * cot).sum()
        jargs, targs = (x, lw, lb, w.T), (x, lw, lb, w)
        tfn = lambda *a: (twa.patch_merge if merge else twa.ln_linear)(*a, eps=1e-5)  # noqa: E731
    with interpret(jwa):
        ref = jax.grad(jfn, argnums=tuple(range(len(jargs))))(*map(jnp.asarray, jargs))
    leaves = [_t(a, grad=True) for a in targs]
    (tfn(*leaves).reshape(cot.shape) * _t(cot)).sum().backward()
    for i, (leaf, r) in enumerate(zip(leaves, ref)):
        r = np.asarray(r).T if i == 3 else r
        assert _rel(leaf.grad.numpy(), r) <= 1e-5, i


def test_msda_bwd_serves_the_first_generation_backward():
    """K13b: ``msda``'s gradients (K6's plain version here) against jax.grad
    through ``ms_deform_attn_pallas``, whose backward is the Pallas
    ``_gather_bwd_kernel`` in interpret mode; 2e-5 of each gradient's max."""
    from grit_tpu.ops import msda_pallas as jmp
    from test_torch_ops import interpret, msda_case

    value, shapes, loc, attn, real_hw = msda_case()
    n, s, m, d = value.shape
    cot = np.random.default_rng(26).standard_normal((n, loc.shape[1], m * d)).astype(np.float32)
    with interpret(jmp):
        ref = jax.grad(lambda v, l, a: (jmp.ms_deform_attn_pallas(v, shapes, l, a) * cot).sum(),
                       argnums=(0, 1, 2))(*map(jnp.asarray, (value, loc, attn)))
    leaves = [_t(a, grad=True) for a in (value.reshape(n, s, m * d), loc, attn)]
    out = tmsda.msda(leaves[0], shapes, leaves[1], leaves[2], _t(real_hw))
    (out * _t(cot)).sum().backward()
    for leaf, r, name in zip(leaves, ref, ("value", "locations", "weights")):
        assert _rel(leaf.grad.numpy(), np.asarray(r).reshape(leaf.shape)) <= 2e-5, name


# ---------------------------------------------------------------------------
# (d) loss and schedule
# ---------------------------------------------------------------------------

def test_nll_loss_matches_jax():
    """1e-6 absolute on an O(1) loss; the token counts equal."""
    rng = np.random.default_rng(24)
    logp = np.log(rng.dirichlet(np.ones(VOCAB), (3, 7))).astype(np.float32)
    caps = rng.integers(4, VOCAB, (3, 7))
    caps[:, 0] = BOS
    caps[1, 4:] = PAD
    caps[2, 2:] = PAD
    ref, ref_n = jxe.nll_loss(jnp.asarray(logp), jnp.asarray(caps), PAD)
    out, out_n = txe.nll_loss(_t(logp), _t(caps), PAD)
    assert abs(float(out) - float(ref)) <= 1e-6 and float(out_n) == float(ref_n)
    empty = np.full((2, 5), PAD)
    assert float(txe.nll_loss(_t(logp[:2, :5]), _t(empty), PAD)[0]) == 0.0


def test_cosine_schedule_and_epoch_tick_match_jax():
    """Every tick over 6 epochs of 50 iterations (warm-up, cosine, the floor),
    counted as the loop counts them (one extra tick per epoch); 2e-6 relative
    (the JAX function computes in f32, the port in f64)."""
    state = txe.TrainState(model=None, optimizer=None)
    jstate = jxe.TrainState(None, None, jnp.asarray(0, jnp.int32))
    for _ in range(6):
        state.epoch_tick()
        jstate = jstate.epoch_tick()
        for _ in range(SCHED["num_its_per_epoch"]):
            assert state.global_steps == int(jstate.global_steps)
            ref = float(joptim.cosine_lr_schedule(jstate.global_steps, **SCHED))
            out = toptim.cosine_lr_schedule(state.global_steps, **SCHED)
            assert abs(out - ref) <= 2e-6 * ref, state.global_steps
            state.global_steps += 1
            jstate = jstate._replace(global_steps=jstate.global_steps + 1)
    assert state.global_steps == 6 * 51


# ---------------------------------------------------------------------------
# twins for the whole step
# ---------------------------------------------------------------------------

def torch_train_captioner(dropout=0.0, det_dropout=0.0, drop_path=0.0, seed=0, **swin_kw):
    from grit_tpu_torch.models.cap_generator import CaptionGenerator
    from grit_tpu_torch.models.captioner import GRITCaptioner
    from grit_tpu_torch.models.det_module import DetectionModule
    from grit_tpu_torch.models.detector import Detector
    from grit_tpu_torch.models.grid_net import GridFeatureNetwork
    from grit_tpu_torch.models.swin import SwinTransformer
    from test_torch_models import torch_captioner

    model = GRITCaptioner(
        Detector(SwinTransformer(**SWIN, drop_path_rate=drop_path,
                                 frozen_stages=FROZEN_STAGES, **swin_kw),
                 DetectionModule(**DET, dropout=det_dropout), hidden_dim=D),
        GridFeatureNetwork(2, d_in=D, d_model=D, n_heads=4, dropout=dropout),
        CaptionGenerator(VOCAB, MAXLEN, 2, PAD, d_model=D, n_heads=4, dropout=dropout))
    model.load_state_dict(torch_captioner(seed).state_dict())   # the perturbed seeded weights
    return model.train()


def jax_train_captioner():
    from grit_tpu.models.captioner import GRITCaptioner
    from grit_tpu.models.det_module import DetectionModule
    from grit_tpu.models.detector import Detector
    from grit_tpu.models.swin import SwinTransformer

    backbone = SwinTransformer(drop_path_rate=0.0, fused_attn=False,
                               frozen_stages=FROZEN_STAGES, **SWIN)
    det = DetectionModule(msda_impl="flat", name="det_module", dropout=0.0, **DET)
    return GRITCaptioner(
        detector=Detector(backbone=backbone, det_module=det, hidden_dim=D),
        grid_feat_dim=D, d_model=D, n_heads=4, vocab_size=VOCAB, max_len=MAXLEN,
        pad_idx=PAD, bos_idx=BOS, eos_idx=3, grid_net_layers=2, cap_gen_layers=2, dropout=0.0)


def captions(seed=30, length=9):
    caps = np.random.default_rng(seed).integers(4, VOCAB, (2, length))
    caps[:, 0] = BOS
    caps[1, 6:] = PAD
    return caps


def torch_batch():
    from grit_tpu_torch.utils.nested import ImageBatch

    imgs, mask = uint8_images()
    return {"samples": ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)),
            "captions": torch.from_numpy(captions())}


def torch_state(model, seed=None):
    freeze = toptim.frozen_mask(model, toptim.swin_frozen_stages_predicate(FROZEN_STAGES))
    opt = toptim.build_optimizer(model, model_lr=SCHED["init_lr"], backbone_lr=BACKBONE_LR,
                                 freeze=freeze)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return txe.TrainState(model, opt, global_steps=1, generator=gen)


# ---------------------------------------------------------------------------
# (e) labels and freeze mask
# ---------------------------------------------------------------------------

def test_labels_and_freeze_mask_match_jax():
    """Every parameter gets the JAX package's optimizer label and freeze flag:
    the JAX trees, filled with a code per leaf, cross through convert.py."""
    model = torch_train_captioner()
    params = jax_params(model)
    code = {"model": 0, "backbone": 1, "frozen": 2}
    jlabels = joptim.split_param_labels(params)
    jfreeze = joptim.frozen_mask(params, joptim.swin_frozen_stages_predicate(FROZEN_STAGES))
    as_sd = convert.params_to_state_dict(jax.tree.map(
        lambda p, lab, fr: np.full(np.shape(p), code[lab] + 10 * int(fr)), params, jlabels,
        jfreeze))
    labels = toptim.split_param_labels(model)
    freeze = toptim.frozen_mask(model, toptim.swin_frozen_stages_predicate(FROZEN_STAGES))
    assert set(as_sd) == set(labels) == set(freeze)
    for name, arr in as_sd.items():
        assert (arr == code[labels[name]] + 10 * int(freeze[name])).all(), name
    assert sum(freeze.values()) > 20 and sum(v == "frozen" for v in labels.values()) == 1
    grouped = {id(p) for g in torch_state(model).optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        assert (id(p) in grouped) == (labels[name] != "frozen" and not freeze[name]), name


def test_state_dict_to_params_inverts_params_to_state_dict():
    from grit_tpu.convert import state_dict_to_params as jax_side

    model = torch_train_captioner()
    tree = convert.state_dict_to_params(model.state_dict())
    ref = jax_side({k: v.numpy() for k, v in model.state_dict().items()})
    flat, flat_ref = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (tree, ref))
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat, flat_ref):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    back = convert.params_to_state_dict(tree)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# (f) one full XE step
# ---------------------------------------------------------------------------

def test_xe_step_matches_jax():
    """One XE step with every dropout and drop-path at 0, from the same
    weights and batch: loss within 1e-5 relative; every gradient leaf within
    1e-4 of that leaf's max (plus 1e-7 absolute, the f32 noise of a gradient
    that is zero in exact arithmetic, such as an attention key bias's); every
    updated parameter within 1e-4 of that leaf's max where the gradient is
    above 1e-6, and within twice the group's learning rate elsewhere (Adam's first
    step is lr * g / (|g| + 1e-8): for |g| near 1e-8 it is rounding noise of
    either sign, so two results differ by at most 2 lr); frozen leaves bit for bit
    unchanged."""
    from grit_tpu.utils.nested import ImageBatch as JaxBatch

    model = torch_train_captioner()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # copies: jax_params returns views of the port's parameters, which the
    # port's optimizer updates in place
    params = {"params": jax.tree.map(np.copy, jax_params(model))}
    jmodel = jax_train_captioner()
    imgs, mask = uint8_images()
    jbatch = {"samples": JaxBatch(jnp.asarray(imgs), jnp.asarray(mask)),
              "captions": jnp.asarray(captions())}

    def jloss(p):
        out = jmodel.apply(p, jbatch["samples"], jbatch["captions"], deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jxe.nll_loss(out, jbatch["captions"], PAD)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tx, labels = joptim.build_optimizer(params)
    freeze = joptim.frozen_mask(params, joptim.swin_frozen_stages_predicate(FROZEN_STAGES))
    jstep = jxe.make_xe_train_step(jmodel, tx, labels, pad_idx=PAD, sched_cfg=SCHED,
                                   backbone_lr=BACKBONE_LR, freeze=freeze, donate=False)
    jstate = jxe.TrainState.create(params, tx).epoch_tick()
    jstate, jmetrics = jax.block_until_ready(jstep(jstate, jbatch, jax.random.PRNGKey(0)))

    state = torch_state(model)
    step = txe.make_xe_train_step(pad_idx=PAD, sched_cfg=SCHED)
    state, metrics = step(state, torch_batch())

    assert abs(float(metrics["loss"]) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert abs(metrics["lr"] - float(jmetrics["lr"])) <= 2e-6 * metrics["lr"]
    assert state.global_steps == int(jstate.global_steps) == 2

    ref_g = convert.params_to_state_dict(jax.tree.map(np.asarray, ref_grads["params"]))
    ref_p = convert.params_to_state_dict(jax.tree.map(np.asarray, jstate.params["params"]))
    tfreeze = toptim.frozen_mask(model, toptim.swin_frozen_stages_predicate(FROZEN_STAGES))
    n_grads = 0
    for name, p in model.named_parameters():
        if p.grad is None:   # frozen, or off the caption path (class/box heads, level_embed)
            assert not ref_g[name].any() or name.endswith("pos_emb.weight"), name
            big = np.zeros(ref_g[name].shape, bool)
        else:
            n_grads += 1
            err = np.abs(p.grad.numpy() - ref_g[name]).max()
            assert err <= 1e-4 * np.abs(ref_g[name]).max() + 1e-7, name
            big = np.abs(ref_g[name]) > 1e-6
        err = np.abs(p.detach().numpy() - ref_p[name])
        tol = 1e-4 * np.abs(ref_p[name]).max()
        lr = BACKBONE_LR if "detector" in name else metrics["lr"]
        assert (err <= np.where(big, tol, 2 * lr)).all(), name
        if tfreeze[name] or name.endswith("pos_emb.weight"):
            assert torch.equal(p.detach(), before[name]), name
            np.testing.assert_array_equal(ref_p[name], before[name].numpy(), err_msg=name)
    assert n_grads > 150
    moved = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])]
    assert len(moved) == n_grads - 1      # pos_emb has a gradient and never moves


# ---------------------------------------------------------------------------
# (g) dropout and drop-path, (h) bf16 with f32 master parameters
# ---------------------------------------------------------------------------

def test_dropout_and_drop_path_follow_the_generator():
    """With the config's rates on: the same generator seed gives the same loss
    and gradients twice, another seed another loss; ``eval()`` ignores both
    and is deterministic; the frozen patch embed and stage 1 get no gradient."""
    model = torch_train_captioner(dropout=0.2, det_dropout=0.1, drop_path=0.3)
    batch = torch_batch()

    def run(seed):
        m = copy.deepcopy(model)
        state = torch_state(m, seed)
        m.train().set_generator(state.generator)
        loss = txe.nll_loss(m(batch["samples"], batch["captions"]), batch["captions"], PAD)[0]
        loss.backward()
        return float(loss.detach()), {n: p.grad for n, p in m.named_parameters()}

    (l1, g1), (l2, g2), (l3, _) = run(5), run(5), run(6)
    assert l1 == l2 and l1 != l3
    assert all((g1[n] is None and g2[n] is None) or torch.equal(g1[n], g2[n]) for n in g1)
    for name, g in g1.items():
        if "backbone.patch_embed" in name or "backbone.layers.0." in name:
            assert g is None, name
    assert g1["detector.backbone.layers.1.blocks.1.attn.relative_position_bias_table"] is not None

    eval_loss = txe.make_eval_loss_step(model, pad_idx=PAD)
    e1, e2 = float(eval_loss(batch)), float(eval_loss(batch))
    assert e1 == e2 and not model.training
    clean = torch_train_captioner()
    assert abs(float(txe.make_eval_loss_step(clean, pad_idx=PAD)(batch)) - e1) <= 1e-6
    model.train()
    assert not model.detector.backbone.layers[0].training      # frozen parts stay in eval()
    assert model.detector.backbone.layers[1].training


def test_checkpointed_blocks_give_the_same_gradients():
    """``use_checkpoint`` recomputes each training block in the backward with
    the same drop-path masks: loss and gradients equal the plain run's to
    f32 rounding (1e-6 of each max)."""
    batch = torch_batch()
    results = []
    for ckpt in (False, True):
        m = torch_train_captioner(dropout=0.0, drop_path=0.3, use_checkpoint=ckpt)
        m.set_generator(torch.Generator().manual_seed(3))
        loss = txe.nll_loss(m(batch["samples"], batch["captions"]), batch["captions"], PAD)[0]
        loss.backward()
        results.append((float(loss.detach()), {n: p.grad for n, p in m.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    for n in g0:
        assert (g0[n] is None) == (g1[n] is None), n
        if g0[n] is not None:
            assert _rel(g1[n].numpy(), g0[n].numpy()) <= 1e-6, n


def test_bf16_step_keeps_f32_master_parameters():
    """A bf16 training step (``to_compute_dtype(master_f32=True)``): every
    parameter and gradient stays f32, the trained ones change, the loss is
    finite and near the f32 loss (5e-2 relative: bf16 activations)."""
    from grit_tpu_torch.models.captioner import to_compute_dtype

    batch = torch_batch()
    step = txe.make_xe_train_step(pad_idx=PAD, sched_cfg=SCHED)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = to_compute_dtype(torch_train_captioner(), dtype, master_f32=True)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state, metrics = step(torch_state(model), batch)
        losses[dtype] = float(metrics["loss"])
        assert np.isfinite(losses[dtype])
        changed = 0
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32, name
            assert p.grad is None or p.grad.dtype == torch.float32, name
            changed += not torch.equal(p.detach(), before[name])
        assert changed > 150
    assert model.cap_generator.compute_dtype == torch.bfloat16
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) <= 5e-2 * losses[torch.float32]


def test_build_captioner_defaults_to_the_gpu():
    from grit_tpu_torch.config import default_caption_config
    from grit_tpu_torch.models.captioner import build_captioner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_captioner(default_caption_config(), seed=None)
    overrides = ["model.backbone=swin_test", "model.grid_feat_dim=64",
                 "model.detector.num_levels=2", "model.vocab_size=20"]
    config = default_caption_config().apply_overrides(overrides)
    model = build_captioner(config, device="cpu", dtype=torch.bfloat16, train=True)
    assert model.training and all(p.dtype == torch.float32 for p in model.parameters())
    assert model.detector.backbone.frozen_stages == 2
    assert model.cap_generator.layers[0].pwff.drop.p == 0.2
    assert model.detector.det_module.decoder_layers[0].dropout.p == 0.1
