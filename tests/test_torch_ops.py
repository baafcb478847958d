"""grit_tpu_torch ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both.  On CPU tensors the
port's kernel wrappers (K1 ``block_step``, K2 ``mlp``, K3 ``msda``) run their
plain versions; those are held here against the JAX package's own oracles
(``block_step_ref``, ``_mlp_ref2``, ``ms_deform_attn_reference``), which the
Pallas kernels are tested against in tests/test_window_attention.py and
tests/test_ops.py.  K8 (``window_attention``), K10a (``ln_linear``,
``patch_merge``) and K10b (``layernorm_rows``) are held against the Pallas
bodies themselves in interpret mode, and the kernels that serve several TPU
bodies against those bodies: ``block_step`` against ``_step_kernel`` (K9),
``msda`` against the first-generation MSDA kernels (K13a, K13c, K13d).  The
CUDA branches are compared with the same plain versions on the card by
chip_smoke.py.

Tolerances: fp32 on both sides; the differences are summation order and
LN's rsqrt, so 1e-5 absolute on O(1) values (2e-5 for MSDA, whose reference
sums corners and points in another order).  The bf16 cases of the attention
core pin its rounding points (q after the scale, P before the value
product), which the Hopper kernel keeps: at most 1% of the outputs may differ
from the Pallas body, each by at most one bf16 ulp (only an f32 summation
order can flip a rounding), where dropping either rounding point changes
~40% of them.  The same holds the bf16 backward's plain version (K5) to the
Pallas ``_bwd_kernel``: P rounded before dV, the score gradient times the
scale rounded before dQ and dK.  In fp32, at the fp32 kernels' own shape
class (head dim 32, window 12), the core's and the backward's plain versions
are held to the same Pallas bodies within 2e-5 of each output's max (1e-5
for the bias gradients).

K2's backward (``_mlp_backward``: the LayerNorm launch, torch's products,
``gelu_bwd`` and ``ln_rows_bwd``, plain versions here) is held against
autograd of ``_mlp_recompute`` and the JAX package's ``_mlp_bwd`` in fp32 and
bf16, and each of its two passes' plain versions against autograd of its
formula (tolerances beside the tests).

The one-launch helpers that chip_smoke.py times on the card (``gemm``,
``attention_core``) run their plain versions here, and those compose to
K1's, K2's and K4's plain versions exactly; every GEMM shape of the shipped
Swin-B configurations passes the shape guard the wrappers check before a
launch.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from grit_tpu.models import swin as jswin
from grit_tpu_torch.config import default_caption_config, default_detection_config
from grit_tpu_torch.models.swin import BACKBONES
from grit_tpu.ops import msda_pallas as jmp

from grit_tpu.ops import msda as jmsda
from grit_tpu.ops import posemb as jposemb
from grit_tpu.ops import window as jwin
from grit_tpu.ops import window_attention as jwa
from grit_tpu_torch.ops import msda as tmsda
from grit_tpu_torch.ops import posemb as tposemb
from grit_tpu_torch.ops import window as twin
from grit_tpu_torch.ops import window_attention as twa
from test_torch_models import torch_one_thread  # noqa: F401

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestWindowHelpers:
    def test_partition_reverse_match_jax(self):
        x = np.random.default_rng(0).standard_normal((2, 12, 18, 5)).astype(np.float32)
        tw = twin.window_partition(_t(x), 6)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jwin.window_partition(x, 6)))
        np.testing.assert_array_equal(twin.window_reverse(tw, 6, 12, 18).numpy(), x)

    @pytest.mark.parametrize("window", [4, 6, 12])
    def test_relative_position_index_matches_jax(self, window):
        np.testing.assert_array_equal(twin.relative_position_index(window).numpy(),
                                      jwin.relative_position_index((window, window)))

    @pytest.mark.parametrize("hp,wp,window,shift", [(12, 18, 6, 3), (24, 48, 12, 6)])
    def test_shifted_window_mask_matches_jax(self, hp, wp, window, shift):
        np.testing.assert_array_equal(twin.shifted_window_mask(hp, wp, window, shift).numpy(),
                                      jwin.shifted_window_mask(hp, wp, window, shift))

    def test_sinusoid_table_matches_jax(self):
        np.testing.assert_array_equal(
            tposemb.sinusoid_encoding_table(21, 32, padding_idx=0).numpy(),
            np.asarray(jposemb.sinusoid_encoding_table(21, 32, padding_idx=0)))


def _block_inputs(seed, b, hp, wp, c, heads, win, real):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    # window-padding tokens carry garbage, as a previous block leaves them
    x = f(b, hp, wp, c)
    return dict(
        x=x, norm_w=1 + f(c, sc=0.1), norm_b=f(c, sc=0.1),
        qkv_w=f(3 * c, c, sc=c ** -0.5), qkv_b=f(3 * c, sc=0.1),
        proj_w=f(c, c, sc=c ** -0.5), proj_b=f(c, sc=0.1),
        table=f((2 * win - 1) ** 2, heads))


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("geom", [
    # (b, Hp, Wp, C, heads, window, real_hw)
    (2, 12, 18, 16, 2, 6, (10, 14)),   # window padding on both axes
    (1, 12, 12, 32, 4, 6, (12, 12)),   # no padding
])
def test_block_step_plain_matches_jax(geom, shift):
    """K1's plain version vs block_step_ref, the Pallas band kernel's oracle."""
    b, hp, wp, c, heads, win, real = geom
    p = _block_inputs(1, b, hp, wp, c, heads, win, real)
    out = twa.block_step(*[_t(p[k]) for k in ("x", "norm_w", "norm_b", "qkv_w", "qkv_b",
                                               "proj_w", "proj_b", "table")],
                         num_heads=heads, window=win, real_hw=real, shift=shift)
    n = win * win
    bias = p["table"][jwin.relative_position_index((win, win)).reshape(-1)]
    bias = bias.reshape(n, n, heads).transpose(2, 0, 1)[None]
    if shift:
        bias = bias + jwin.shifted_window_mask(hp, wp, win, shift)[:, None]
    # the JAX kernel contract takes the map pre-rolled by -shift and returns
    # it rolled; the port takes and returns it unrolled
    ref = jwa.block_step_ref(
        jnp.asarray(np.roll(p["x"], (-shift, -shift), (1, 2))), p["norm_w"], p["norm_b"],
        p["qkv_w"].T, p["qkv_b"], p["proj_w"].T, p["proj_b"], jnp.asarray(bias),
        scale=(c // heads) ** -0.5, num_heads=heads, window=win, real_hw=real,
        shift=shift, residual=True, eps=1e-5)
    ref = np.roll(np.asarray(ref), (shift, shift), (1, 2))
    h, w = real  # outputs at window-padding tokens are unspecified
    np.testing.assert_allclose(out.numpy()[:, :h, :w], ref[:, :h, :w], atol=ATOL, rtol=0)
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("rows,c", [(36, 16), (50, 32)])
def test_mlp_plain_matches_jax(rows, c):
    """K2's plain version vs _mlp_ref2, the Pallas MLP kernel's oracle."""
    rng = np.random.default_rng(2)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    x, lw, lb = f(rows, c), 1 + f(c, sc=0.1), f(c, sc=0.1)
    w1, b1, w2, b2 = f(4 * c, c, sc=c ** -0.5), f(4 * c, sc=0.1), f(c, 4 * c, sc=0.5 / c), f(c)
    out = twa.mlp(*map(_t, (x, lw, lb, w1, b1, w2, b2)))
    ref = jwa._mlp_ref2(x, lw, lb, w1.T, b1, w2.T, b2, 1e-5, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _share(a, ref) -> float:
    """max |a - ref| as a share of max |ref|, in f32."""
    a, ref = (np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)
              for t in (a, ref))
    return float(np.abs(a - ref).max() / np.abs(ref).max())


# K2's backward as the CUDA path composes it: the LayerNorm launch, torch's
# products, gelu_bwd, ln_rows_bwd (their plain versions on the CPU).  fp32:
# 1e-5 of each gradient's max from both yardsticks.  bf16: 4e-3 (one bf16 step
# of the largest value) from autograd of _mlp_recompute, which rounds at the
# same points and differs only in the order of the derivatives' f32 terms;
# 2e-2 from the JAX _mlp_bwd, which keeps fc1's pre-activation in f32
# (autograd itself reads up to 7e-3 from it)
MLP_BWD_TOL = {"f32": (1e-5, 1e-5), "bf16": (4e-3, 2e-2)}


@pytest.mark.parametrize("dtype,residual,bias", [
    ("f32", True, True), ("f32", False, True), ("f32", False, False),
    ("bf16", True, True), ("bf16", False, True), ("bf16", False, False)])
def test_mlp_backward_matches_autograd_and_jax(dtype, residual, bias):
    """The gradients of ``mlp`` (``_mlp_backward``) to its inputs, with and
    without the residual, and without fc2's bias (a tensor-parallel rank's
    partial), against autograd of ``_mlp_recompute`` and the JAX package's
    ``_mlp_bwd`` (jax.vjp of ``_mlp_ref2``); each gradient in its input's
    dtype."""
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    rows, c = 50, 32
    f = _f(np.random.default_rng(31))
    x, lw, lb = f(rows, c) * 2 + 0.3, 1 + f(c, sc=0.1), f(c, sc=0.1)
    w1, b1, w2, b2 = f(4 * c, c, sc=c ** -0.5), f(4 * c, sc=0.1), f(c, 4 * c, sc=0.5 / c), f(c)
    dy = f(rows, c)
    if not bias:
        b2 = np.zeros_like(b2)
    ins = [_t(x).to(tdt), _t(lw), _t(lb), *(_t(a).to(tdt) for a in (w1, b1, w2, b2))]
    leaves = [t.clone().requires_grad_() for t in ins[:6]]
    fc2_b = ins[6].clone().requires_grad_() if bias else None
    got = torch.autograd.grad(twa.mlp(*leaves, fc2_b, residual=residual),
                              leaves + [fc2_b] * bias, _t(dy).to(tdt))
    leaves = [t.clone().requires_grad_() for t in ins[:6]]
    fc2_b = ins[6].clone().requires_grad_() if bias else None
    ref = torch.autograd.grad(twa._mlp_recompute(*leaves, fc2_b, 1e-5, residual),
                              leaves + [fc2_b] * bias, _t(dy).to(tdt))
    res = (jnp.asarray(x, jdt), jnp.asarray(lw), jnp.asarray(lb), jnp.asarray(w1.T, jdt),
           jnp.asarray(b1, jdt), jnp.asarray(w2.T, jdt), jnp.asarray(b2, jdt))
    jax_grads = jwa._mlp_bwd(1e-5, residual, res, jnp.asarray(dy, jdt))
    tol_autograd, tol_jax = MLP_BWD_TOL[dtype]
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == ins[i].dtype, i
        j = np.asarray(jax_grads[i], np.float32)
        j = j.T if i in (3, 5) else j
        assert _share(g, r) <= tol_autograd, (i, _share(g, r))
        assert _share(g, j) <= tol_jax, (i, _share(g, j))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gelu_bwd_plain_matches_autograd(dtype):
    """``gelu_bwd_plain`` against autograd of the GELU as ``_mlp_recompute``
    writes it, in f32 on the rounded pre-activation: g equal, du within 1e-6
    of its max (the derivative's terms in another order; bf16: one bf16 step,
    4e-3), the bias gradient the f32 sum of du as rounded."""
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    f = _f(np.random.default_rng(32))
    u, dg = _t(f(40, 64) * 2).to(tdt), _t(f(40, 64)).to(tdt)
    uf = u.float().clone().requires_grad_()
    t = uf * 0.5 * (1.0 + torch.erf(uf * 0.7071067811865476))
    du_ref, = torch.autograd.grad(t, uf, dg.float())
    g, du, db = twa.gelu_bwd_plain(u, dg)
    assert g.dtype == du.dtype == db.dtype == tdt
    assert torch.equal(g, t.detach().to(tdt))
    assert _share(du, du_ref) <= (4e-3 if dtype == "bf16" else 1e-6)
    assert torch.equal(db, du.float().sum(0).to(tdt))


@pytest.mark.parametrize("residual", [False, True])
def test_ln_rows_bwd_plain_matches_autograd(residual):
    """``ln_rows_bwd_plain`` against autograd of ``_ln_fast`` (the forward's
    formula, var = E[x^2] - mu^2) in f32: dx (+ the residual's ``dy``) and the
    scale's and bias's gradients within 1e-5 of each max."""
    f = _f(np.random.default_rng(33))
    x, w, b, d_xn, dy = (_t(a) for a in (f(40, 48) * 3 + 1.0, 1 + f(48, sc=0.1),
                                         f(48, sc=0.1), f(40, 48), f(40, 48)))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ref = list(torch.autograd.grad(twa._ln_fast(*leaves, 1e-5), leaves, d_xn))
    if residual:
        ref[0] = ref[0] + dy
    got = twa.ln_rows_bwd_plain(x, w, d_xn, dy if residual else None, eps=1e-5)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert _share(g, r) <= 1e-5, _share(g, r)


@pytest.mark.parametrize("padded", [False, True])
def test_msda_plain_matches_jax_reference(padded):
    """K3's plain version (taps masked by real_hw) vs ms_deform_attn_reference
    on the pre-masked value, as the JAX package's non-pallas path feeds it."""
    rng = np.random.default_rng(3)
    shapes = ((6, 8), (3, 4))
    n, lq, m, d, p = 2, 5, 2, 4, 3
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m * d)).astype(np.float32)
    loc = (rng.random((n, lq, m, len(shapes), p, 2)) * 1.3 - 0.15).astype(np.float32)
    attn = rng.random((n, lq, m, len(shapes), p)).astype(np.float32)
    attn /= attn.reshape(n, lq, m, -1).sum(-1)[..., None, None]
    real_hw = np.array([[h, w] for h, w in shapes] * n).reshape(n, len(shapes), 2)
    if padded:
        real_hw[1] = [[4, 5], [2, 3]]
    masked = value.copy()
    for lid, ((h, w), st) in enumerate(zip(shapes, jmsda.level_start_index(shapes))):
        lv = masked[:, st:st + h * w].reshape(n, h, w, -1)
        for i in range(n):
            lv[i, real_hw[i, lid, 0]:] = 0
            lv[i, :, real_hw[i, lid, 1]:] = 0
        masked[:, st:st + h * w] = lv.reshape(n, h * w, -1)
    out = tmsda.msda(_t(value), shapes, _t(loc), _t(attn), _t(real_hw))
    ref = jmsda.ms_deform_attn_reference(masked.reshape(n, s, m, d), shapes, loc, attn)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# K8, K9, K10a, K10b, K13: against the Pallas bodies in interpret mode
# ---------------------------------------------------------------------------

def interpret(module):
    """Run ``module``'s ``pallas_call``s in interpret mode, as the JAX
    package's own tests do on the CPU."""
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    return mock.patch.object(module.pl, "pallas_call", interp)


def _f(rng):
    return lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)


@pytest.mark.parametrize("m_windows", ["one", "every"])
def test_window_attention_matches_jax_kernel(m_windows):
    """K8's plain version vs the Pallas ``_kernel`` (fused_window_attention),
    with a bias over one window and over every window."""
    b, nw, heads, n, d = 3, 4, 2, 16, 8
    f = _f(np.random.default_rng(4))
    q, k, v = (f(b, nw, n, heads * d) for _ in range(3))
    bias = f(1 if m_windows == "one" else nw, heads, n, n)
    with interpret(jwa):
        ref = jwa.fused_window_attention(*map(jnp.asarray, (q, k, v, bias)), 0.3, heads)
    out = twa.window_attention(_t(q), _t(k), _t(v), _t(bias), 0.3, heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shift", [0, 4])
def test_block_step_serves_the_step_kernel(shift):
    """K9: ``block_step`` against the Pallas ``_step_kernel`` (the
    ``GRIT_WA_BAND=0`` layout of K1's function), which it maps onto."""
    b, hp, wp, c, heads, win, real = 2, 16, 24, 16, 2, 8, (13, 20)
    p = _block_inputs(5, b, hp, wp, c, heads, win, real)
    out = twa.block_step(*[_t(p[k]) for k in ("x", "norm_w", "norm_b", "qkv_w", "qkv_b",
                                               "proj_w", "proj_b", "table")],
                         num_heads=heads, window=win, real_hw=real, shift=shift)
    n = win * win
    bias = p["table"][jwin.relative_position_index((win, win)).reshape(-1)]
    bias = bias.reshape(n, n, heads).transpose(2, 0, 1)[None]
    if shift:
        bias = bias + jwin.shifted_window_mask(hp, wp, win, shift)[:, None]
    with interpret(jwa):
        ref = jwa._step_forward(
            jnp.asarray(np.roll(p["x"], (-shift, -shift), (1, 2))), p["norm_w"], p["norm_b"],
            p["qkv_w"].T, p["qkv_b"], p["proj_w"].T, p["proj_b"], jnp.asarray(bias),
            (c // heads) ** -0.5, heads, win, real, shift, True, 1e-5)
    ref = np.roll(np.asarray(ref), (shift, shift), (1, 2))
    h, w = real
    np.testing.assert_allclose(out.numpy()[:, :h, :w], ref[:, :h, :w], atol=ATOL, rtol=0)


def test_ln_linear_matches_jax_kernel():
    """K10a on rows: ``ln_linear`` vs the Pallas ``_lnlin_kernel`` (fused_ln_linear)."""
    f = _f(np.random.default_rng(6))
    x, lw, lb, w = f(2, 24, 64) * 2 + 0.5, 1 + f(64, sc=0.1), f(64, sc=0.1), f(32, 64, sc=0.125)
    with interpret(jwa):
        ref = jwa.fused_ln_linear(jnp.asarray(x), lw, lb, jnp.asarray(w.T), eps=1e-5)
    out = twa.ln_linear(_t(x), _t(lw), _t(lb), _t(w), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(8, 12), (7, 11)])
def test_patch_merge_matches_jax_patch_merging(hw):
    """K10a on the stage map: ``patch_merge`` (2x2 gather, odd-edge zero pad,
    LayerNorm over 4C, reduction) vs the JAX package's PatchMerging module on
    its default path, from the same parameters."""
    h, w = hw
    c, out_dim = 16, 24
    f = _f(np.random.default_rng(7))
    x = f(2, h, w, c)
    params = {"norm": {"scale": 1 + f(4 * c, sc=0.1), "bias": f(4 * c, sc=0.1)},
              "reduction": {"kernel": f(4 * c, out_dim, sc=0.125)}}
    ref = jswin.PatchMerging(c, out_dim).apply({"params": params},
                                               jnp.asarray(x.reshape(2, h * w, c)), (h, w))
    out = twa.patch_merge(_t(x), _t(params["norm"]["scale"]), _t(params["norm"]["bias"]),
                          _t(np.ascontiguousarray(params["reduction"]["kernel"].T)), eps=1e-5)
    assert out.shape == (2, (h + 1) // 2, (w + 1) // 2, out_dim)
    np.testing.assert_allclose(out.numpy().reshape(2, -1, out_dim), np.asarray(ref),
                               atol=ATOL, rtol=0)


def test_layernorm_rows_matches_jax_kernel():
    """K10b: ``layernorm_rows`` vs the Pallas ``_ln_kernel`` (fused_layernorm)."""
    f = _f(np.random.default_rng(8))
    x, lw, lb = f(2, 40, 16) * 3 - 1, 1 + f(16, sc=0.1), f(16, sc=0.1)
    with interpret(jwa):
        ref = jwa.fused_layernorm(jnp.asarray(x), lw, lb, eps=1e-5)
    out = twa.layernorm_rows(_t(x), _t(lw), _t(lb), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def msda_case(seed=9):
    """MSDA inputs whose level sizes (24, 6, 4 rows) are not all multiples of
    8, so the relaid layout's re-lay runs; locations spill past [0, 1]."""
    rng = np.random.default_rng(seed)
    shapes = ((4, 6), (2, 3), (2, 2))
    n, lq, m, d, p = 2, 5, 2, 4, 2
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((n, s, m, d)).astype(np.float32)
    loc = (rng.random((n, lq, m, len(shapes), p, 2)) * 1.3 - 0.15).astype(np.float32)
    attn = rng.random((n, lq, m, len(shapes), p)).astype(np.float32)
    attn /= attn.reshape(n, lq, m, -1).sum(-1)[..., None, None]
    real_hw = np.array([[h, w] for h, w in shapes] * n).reshape(n, len(shapes), 2)
    return value, shapes, loc, attn, real_hw


@pytest.mark.parametrize("body", ["K13a _gather_matmul_kernel", "K13c _gather_matmul_kernel_v3",
                                  "K13d _gather_matmul_kernel_v4"])
def test_msda_serves_the_first_generation_kernels(body, monkeypatch):
    """``msda`` against the three earlier Pallas MSDA forwards, which map
    onto it; 2e-5 (they sum corners and points in another order)."""
    value, shapes, loc, attn, real_hw = msda_case()
    n, s, m, d = value.shape
    with interpret(jmp):
        if body.startswith("K13d"):
            monkeypatch.setenv("GRIT_MSDA_V5", "0")
            relaid = jmp.relay_value(jnp.asarray(value.reshape(n, s, m * d)), shapes)
            ref = jmp.ms_deform_attn_pallas_relaid(relaid, shapes, loc, attn)
        else:
            monkeypatch.setattr(jmp, "FWD_VARIANT", "v3" if body.startswith("K13c") else "v2")
            ref = jmp.ms_deform_attn_pallas(jnp.asarray(value), shapes, loc, attn)
    out = tmsda.msda(_t(value.reshape(n, s, m * d)), shapes, _t(loc), _t(attn), _t(real_hw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# The bf16 attention core's rounding points; the GEMM's shape guard; the
# one-launch helpers' plain versions
# ---------------------------------------------------------------------------

def _bf16(a):
    """numpy f32 -> (the same values rounded to bf16 as jnp, as torch)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("bias_kind", ["dense bias (K8)", "table and shift (K1, K4)"])
def test_attention_core_plain_bf16_matches_jax_kernel(bias_kind):
    """bf16: the core's plain version against the Pallas ``_kernel`` in
    interpret mode, which rounds q after its scale and P before the value
    product as the Hopper kernel does.  K8's ``window_attention_plain`` on a
    dense bias; ``attention_core_plain`` (q pre-scaled, the bias from its
    table and the shifted-window mask) against the body fed that bias as a
    dense tensor and scale 1."""
    rng = np.random.default_rng(10)
    b, hp, wp, heads, d, win, shift = 2, 12, 18, 2, 16, 6, 3
    n, nw, c = win * win, (hp // win) * (wp // win), heads * d
    f = _f(rng)
    if bias_kind.startswith("dense"):
        q, k, v = (f(b, nw, n, c) for _ in range(3))
        bias, scale = f(nw, heads, n, n), 0.3
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        out = twa.window_attention_plain(tq, tk, tv, _t(bias), scale, heads).float().numpy()
    else:
        qkv = f(b * nw * n, 3 * c)
        qkv[:, :c] *= d ** -0.5
        table = f((2 * win - 1) ** 2, heads)
        jqkv, tqkv = _bf16(qkv)
        out = twa.attention_core_plain(tqkv, _t(table), batch=b, hp=hp, wp=wp, num_heads=heads,
                                       window=win, shift=shift).float().numpy()
        out = out.reshape(b, nw, n, c)
        jq, jk, jv = (jqkv[:, i * c:(i + 1) * c].reshape(b, nw, n, c) for i in range(3))
        bias = table[jwin.relative_position_index((win, win)).reshape(-1)]
        bias = bias.reshape(n, n, heads).transpose(2, 0, 1)[None]
        bias = bias + jwin.shifted_window_mask(hp, wp, win, shift)[:, None]
        scale = 1.0
    with interpret(jwa):
        ref = jwa.fused_window_attention(jq, jk, jv, jnp.asarray(bias), scale, heads)
    ref = np.asarray(ref.astype(jnp.float32)).reshape(out.shape)
    ulp = 2.0 ** -7 * np.abs(ref).max()          # one bf16 ulp at the largest output
    assert np.mean(out != ref) <= 0.01
    np.testing.assert_allclose(out, ref, atol=ulp, rtol=0)


@pytest.mark.parametrize("shift", [0, 3])
def test_window_attention_bwd_plain_bf16_matches_jax_kernel(shift):
    """bf16: K5's plain version against the Pallas ``_bwd_kernel`` in
    interpret mode (``_backward``), fed the same bf16 qkv (q pre-scaled), the
    gradient of the output, and the table and shift mask as a dense bias with
    scale 1.  Head dim 16 makes the port's scale 0.25, a power of two, so the
    body's rounding of dS and the port's of dS * 0.25 round alike and the
    port's dq is the body's times 0.25 exactly.  dq, dk, dv: at most 1% of the
    outputs one bf16 ulp apart (dropping the dS rounding, or P's before dV,
    moves ~40%); dtable (f32) against the body's per-window bias gradient
    scattered into the table, 1e-5 of its max."""
    rng = np.random.default_rng(12 + shift)
    b, hp, wp, heads, d, win = 2, 12, 18, 2, 16, 6
    n, nw, c = win * win, (hp // win) * (wp // win), heads * d
    f = _f(rng)
    qkv = f(b * nw * n, 3 * c)
    qkv[:, :c] *= d ** -0.5
    table = f((2 * win - 1) ** 2, heads)
    (jqkv, tqkv), (jdo, tdo) = _bf16(qkv), _bf16(f(b * nw * n, c))
    dqkv, dtable = twa.window_attention_bwd_plain(tqkv, tdo, _t(table), batch=b, hp=hp, wp=wp,
                                                  num_heads=heads, window=win, shift=shift)
    dqkv = dqkv.float().numpy().reshape(b, nw, n, 3 * c)
    jq, jk, jv = (jqkv[:, i * c:(i + 1) * c].reshape(b, nw, n, c) for i in range(3))
    idx = jwin.relative_position_index((win, win)).reshape(-1)
    bias = table[idx].reshape(n, n, heads).transpose(2, 0, 1)[None]
    if shift:
        bias = bias + jwin.shifted_window_mask(hp, wp, win, shift)[:, None]
    with interpret(jwa):
        *grads, dbias = jwa._backward(jq, jk, jv, jnp.asarray(bias, jnp.float32), 1.0, heads,
                                      jdo.reshape(b, nw, n, c))
    for i, (name, g, factor) in enumerate(zip(("dq", "dk", "dv"), grads, (d ** -0.5, 1.0, 1.0))):
        ref = np.asarray(g.astype(jnp.float32)) * factor
        out = dqkv[..., i * c:(i + 1) * c]
        ulp = 2.0 ** -7 * np.abs(ref).max()
        assert np.mean(out != ref) <= 0.01, name
        np.testing.assert_allclose(out, ref, atol=ulp, rtol=0, err_msg=name)
    ref_table = np.zeros_like(table)
    np.add.at(ref_table, idx, np.asarray(dbias).sum(0).reshape(heads, n * n).T)
    np.testing.assert_allclose(dtable.numpy(), ref_table, atol=1e-5 * np.abs(ref_table).max(),
                               rtol=0)



# the fp32 kernels' own shape class: head dim 32, window 12 (N = 144, nine
# 16-row strips), two windows of a 24x24 map a row
F32_GEO = dict(b=2, hp=24, wp=24, heads=2, d=32, win=12)


def _f32_bias(table, win, hp, wp, shift):
    """The table (and the shifted-window mask) as the dense bias the Pallas
    bodies take: [1 or nW, heads, N, N]."""
    n = win * win
    idx = jwin.relative_position_index((win, win)).reshape(-1)
    bias = table[idx].reshape(n, n, -1).transpose(2, 0, 1)[None]
    if shift:
        bias = bias + jwin.shifted_window_mask(hp, wp, win, shift)[:, None]
    return bias.astype(np.float32)


@pytest.mark.parametrize("case", ["dense bias (K8)", "table shift=0", "table shift=6"])
def test_attention_core_plain_f32_matches_jax_kernel(case):
    """fp32 at the kernel's shape class: the core's plain versions, which
    chip_smoke.py holds the fp32 Hopper kernel (win_attn_f32.cu) to on the
    card, against the Pallas ``_kernel`` in interpret mode: K8's
    ``window_attention_plain`` on a dense bias, ``attention_core_plain`` (q
    pre-scaled, the table and the shifted-window mask) against the body fed
    that bias densely with scale 1.  2e-5 of the output's max (summation
    order only)."""
    g = F32_GEO
    b, hp, wp, heads, d, win = g["b"], g["hp"], g["wp"], g["heads"], g["d"], g["win"]
    n, nw, c = win * win, (hp // win) * (wp // win), heads * d
    f = _f(np.random.default_rng(30))
    if case.startswith("dense"):
        q, k, v = (f(b, nw, n, c) for _ in range(3))
        bias, scale = f(nw, heads, n, n), d ** -0.5
        out = twa.window_attention_plain(_t(q), _t(k), _t(v), _t(bias), scale, heads).numpy()
    else:
        shift = int(case.split("=")[1])
        qkv = f(b * nw * n, 3 * c)
        qkv[:, :c] *= d ** -0.5
        table = f((2 * win - 1) ** 2, heads)
        out = twa.attention_core_plain(_t(qkv), _t(table), batch=b, hp=hp, wp=wp,
                                       num_heads=heads, window=win, shift=shift).numpy()
        out = out.reshape(b, nw, n, c)
        q, k, v = (qkv[:, i * c:(i + 1) * c].reshape(b, nw, n, c) for i in range(3))
        bias, scale = _f32_bias(table, win, hp, wp, shift), 1.0
    with interpret(jwa):
        ref = jwa.fused_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(bias), scale, heads)
    ref = np.asarray(ref).reshape(out.shape)
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("case", ["dense bias (K8)", "table shift=0", "table shift=6"])
def test_window_attention_bwd_plain_f32_matches_jax_kernel(case):
    """fp32 at the kernel's shape class: the backward's plain versions, which
    chip_smoke.py holds the fp32 backward kernel to on the card, against the
    Pallas ``_bwd_kernel`` in interpret mode (``_backward``).  K5's
    ``window_attention_bwd_plain`` (q pre-scaled by s = d^-1/2, so its dq is
    the body's times s) with the table and the shift mask fed to the body
    densely at scale 1, its dtable against the body's per-window bias
    gradient scattered into the table; K8's ``window_attention`` backward on
    a dense bias (the plain version through autograd on the CPU), its bias
    gradient against the body's.  dq, dk, dv within 2e-5 of each one's max,
    the bias gradients within 1e-5."""
    g = F32_GEO
    b, hp, wp, heads, d, win = g["b"], g["hp"], g["wp"], g["heads"], g["d"], g["win"]
    n, nw, c = win * win, (hp // win) * (wp // win), heads * d
    f = _f(np.random.default_rng(31))
    do = f(b, nw, n, c)
    if case.startswith("dense"):
        q, k, v = (f(b, nw, n, c) for _ in range(3))
        bias, scale = f(nw, heads, n, n), d ** -0.5
        leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
        out = twa.window_attention(*leaves, scale, heads)
        grads = torch.autograd.grad(out, leaves, _t(do))
        outs, factors = [t.numpy() for t in grads[:3]], (1.0, 1.0, 1.0)
        dbias_out = grads[3].numpy()
    else:
        shift = int(case.split("=")[1])
        qkv = f(b * nw * n, 3 * c)
        qkv[:, :c] *= d ** -0.5
        table = f((2 * win - 1) ** 2, heads)
        dqkv, dtable = twa.window_attention_bwd_plain(
            _t(qkv), _t(do.reshape(-1, c)), _t(table), batch=b, hp=hp, wp=wp, num_heads=heads,
            window=win, shift=shift)
        dqkv = dqkv.numpy().reshape(b, nw, n, 3 * c)
        outs = [dqkv[..., i * c:(i + 1) * c] for i in range(3)]
        factors = (d ** -0.5, 1.0, 1.0)
        q, k, v = (qkv[:, i * c:(i + 1) * c].reshape(b, nw, n, c) for i in range(3))
        bias, scale = _f32_bias(table, win, hp, wp, shift), 1.0
    with interpret(jwa):
        *refs, dbias = jwa._backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(bias), scale, heads, jnp.asarray(do))
    for name, out, ref, factor in zip(("dq", "dk", "dv"), outs, refs, factors):
        ref = np.asarray(ref) * factor
        np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=0, err_msg=name)
    dbias = np.asarray(dbias)
    if case.startswith("dense"):
        ref_bias = dbias.reshape(dbias_out.shape)
        np.testing.assert_allclose(dbias_out, ref_bias, atol=1e-5 * np.abs(ref_bias).max(),
                                   rtol=0)
    else:
        idx = jwin.relative_position_index((win, win)).reshape(-1)
        ref_table = np.zeros_like(table)
        np.add.at(ref_table, idx, dbias.sum(0).reshape(heads, n * n).T)
        np.testing.assert_allclose(dtable.numpy(), ref_table,
                                   atol=1e-5 * np.abs(ref_table).max(), rtol=0)

def _swin_products(config) -> list[tuple[str, int, int]]:
    """(name, N, K) of every product of the config's Swin backbone: qkv,
    proj, fc1 and fc2 of each stage's blocks and its PatchMerging reduction."""
    bb = BACKBONES[config.model.backbone]
    depths, c0 = bb["depths"], bb["embed_dim"]
    outs = [c0 * 2 ** i for i in range(1, len(depths))] + [bb["pos_dim"]]
    prods = []
    for i in range(len(depths)):
        c = c0 * 2 ** i
        prods += [(f"stage{i + 1} qkv", 3 * c, c), (f"stage{i + 1} proj", c, c),
                  (f"stage{i + 1} fc1", 4 * c, c), (f"stage{i + 1} fc2", c, 4 * c),
                  (f"stage{i + 1} merge", outs[i], 4 * c)]
    return prods


@pytest.mark.parametrize("which", ["caption 384x640", "detection 832x1344"])
def test_every_shipped_swin_product_passes_the_gemm_guard(which):
    """Every GEMM that the shipped Swin-B configurations give (at their own
    image sizes) tiles the bf16 wgmma kernel and the fp32 one, so no
    main-path shape first meets the guard on the card."""
    if which.startswith("caption"):
        config = default_caption_config()
        hw = tuple(config.dataset.transform_cfg.size)
    else:
        config = default_detection_config()
        hw = tuple(config.dataset.fixed_bucket)
    assert f"{hw[0]}x{hw[1]}" in which
    prods = _swin_products(config)
    assert len(prods) == 5 * len(BACKBONES[config.model.backbone]["depths"])
    for name, n_out, k_in in prods:
        for dtype in (torch.bfloat16, torch.float32):
            twa.check_gemm_shape(n_out, k_in, dtype, name)


@pytest.mark.parametrize("n_out,k_in,dtype", [(100, 128, torch.bfloat16),
                                              (384, 100, torch.bfloat16),
                                              (202, 64, torch.float32), (128, 72, torch.float32),
                                              (128, 128, torch.float16)])
def test_gemm_guard_refuses_shapes_that_do_not_tile(n_out, k_in, dtype):
    """The guard refuses what the kernels do not take: bf16 rows that are no
    whole 16 bytes (N or K % 8), fp32 columns in no whole float4 (N % 4) or
    K in no whole 16-deep step, and other dtypes."""
    with pytest.raises(ValueError):
        twa.check_gemm_shape(n_out, k_in, dtype)


@pytest.mark.parametrize("case", ["K1 shift=0", "K1 shift=3", "K4 shift=0", "K4 shift=3",
                                  "K2 residual", "K2 branch"])
def test_one_launch_helpers_compose_to_the_block_plain_versions(case):
    """``gemm`` and ``attention_core`` (their plain versions on the CPU),
    launched as the CUDA paths of K1, K4 and K2 launch them, give the whole
    functions' plain versions exactly."""
    f = _f(np.random.default_rng(11))
    if case.startswith("K2"):
        residual = case.endswith("residual")
        rows, c = 50, 32
        x, lw, lb = _t(f(rows, c)), _t(1 + f(c, sc=0.1)), _t(f(c, sc=0.1))
        w1, b1, w2, b2 = (_t(f(4 * c, c, sc=c ** -0.5)), _t(f(4 * c, sc=0.1)),
                          _t(f(c, 4 * c, sc=0.5 / c)), _t(f(c)))
        h = twa.gemm(twa._ln_fast(x, lw, lb, 1e-5), w1, b1, epilogue="gelu")
        out = twa.gemm(h, w2, b2, epilogue="resid" if residual else "bias",
                       resid=x if residual else None)
        ref = twa.mlp_plain(x, lw, lb, w1, b1, w2, b2, residual=residual)
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
        return
    shift = int(case.split("=")[1])
    b, hp, wp, c, heads, win, real = 2, 12, 18, 16, 2, 6, (10, 14)
    p = {k: _t(v) for k, v in _block_inputs(12, b, hp, wp, c, heads, win, real).items()}
    qs = dict(scale=(c // heads) ** -0.5, scale_cols=c)
    core = dict(batch=b, hp=hp, wp=wp, num_heads=heads, window=win, shift=shift)
    if case.startswith("K1"):
        xs = torch.roll(p["x"], (-shift, -shift), (1, 2)) if shift else p["x"]
        pad = twa._pad_mask(hp, wp, real, shift, "cpu")
        xn = twa._ln_fast(xs.masked_fill(pad, 0.0), p["norm_w"], p["norm_b"], 1e-5)
        xn = twin.window_partition(xn.masked_fill(pad, 0.0), win).reshape(-1, c)
        ao = twa.attention_core(twa.gemm(xn, p["qkv_w"], p["qkv_b"], **qs), p["table"], **core)
        out = twa.gemm(ao, p["proj_w"], p["proj_b"], epilogue="resid_map", resid=p["x"],
                       geo=(hp, wp, win, shift, *real)).reshape(b, hp, wp, c)
        ref = twa.block_step_plain(*[p[k] for k in ("x", "norm_w", "norm_b", "qkv_w", "qkv_b",
                                                     "proj_w", "proj_b", "table")],
                                   num_heads=heads, window=win, real_hw=real, shift=shift)
        h, w = real
        np.testing.assert_array_equal(out.numpy()[:, :h, :w], ref.numpy()[:, :h, :w])
        return
    geo = (hp, wp, win, shift, hp, wp)
    qkv = twa.gemm(p["x"], p["qkv_w"], p["qkv_b"], geo=geo, gather=True, **qs)
    ao = twa.attention_core(qkv, p["table"], **core)
    out = twa.gemm(ao, p["proj_w"], p["proj_b"], epilogue="map", geo=geo).reshape(b, hp, wp, c)
    ref, ref_ao, ref_qkv = twa.block_attention_plain(
        *[p[k] for k in ("x", "qkv_w", "qkv_b", "proj_w", "proj_b", "table")],
        num_heads=heads, window=win, shift=shift)
    for a, r in ((qkv, ref_qkv), (ao, ref_ao), (out, ref)):
        np.testing.assert_array_equal(a.numpy(), r.numpy())
