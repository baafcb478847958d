"""grit_tpu_torch ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both.  On CPU tensors the
port's kernel wrappers (K1 ``block_step``, K2 ``mlp``, K3 ``msda``) run their
plain versions; those are held here against the JAX package's own oracles
(``block_step_ref``, ``_mlp_ref2``, ``ms_deform_attn_reference``), which the
Pallas kernels are tested against in tests/test_window_attention.py and
tests/test_ops.py.  The CUDA branches are compared with the same plain
versions on the card by chip_smoke.py.

Tolerances: fp32 on both sides; the differences are summation order and
LN's rsqrt, so 1e-5 absolute on O(1) values (2e-5 for MSDA, whose reference
sums corners and points in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
