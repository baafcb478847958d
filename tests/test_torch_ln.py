"""The LayerNorm kernels' wrappers (K10b ``layernorm_rows``, K10a
``patch_merge``) against the JAX package, on the CPU, at widths the other
tests do not take, and the shape guard that every LayerNorm launch passes.

``check_ln_shape`` holds the widths that ``ln_rows_kernel`` and
``ln_merge_kernel`` (csrc/swin_block.cu) take: rows of whole 16-byte chunks.
Every LN width of every Swin preset passes it in both types: the patch-embed
norm's C, each stage's C (K1's LN1, K2's LN2) and each PatchMerging's map C
(its norm runs over 4C).  On CPU tensors the wrappers run their plain
versions, held here to the Pallas bodies in interpret mode (``_ln_kernel``
through ``fused_layernorm``, ``_lnlin_kernel`` through ``fused_ln_linear``
on the rows gathered as the JAX PatchMerging gathers them, odd maps
zero-padded) at C = 96 and 192 (the small, tiny and large presets' widths).
Tolerance as the other K10 tests: fp32 on both sides, 1e-5 absolute on O(1)
outputs (summation order and LN's rsqrt).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.ops import window_attention as jwa
from grit_tpu_torch.models.swin import BACKBONES
from grit_tpu_torch.ops import window_attention as twa
from test_torch_models import torch_one_thread  # noqa: F401
from test_torch_ops import ATOL, _f, _t, interpret


def _ln_widths(preset: str) -> list[int]:
    """The rows' widths of a preset's LayerNorm launches: the patch-embed
    norm's C, each stage's C, and each PatchMerging's map C (the merge
    kernel's row is 4C of it; ``check_ln_shape`` takes the map C for it) and
    4C (the same norm on rows that are merged already)."""
    cfg = BACKBONES[preset]
    stages = [cfg["embed_dim"] * 2 ** i for i in range(len(cfg["depths"]))]
    return sorted({cfg["embed_dim"], *stages, *(4 * c for c in stages)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("preset", sorted(BACKBONES))
def test_check_ln_shape_takes_every_preset_width(preset, dtype):
    for c in _ln_widths(preset):
        twa.check_ln_shape(c, dtype, f"{preset} C={c}")


@pytest.mark.parametrize("c,dtype", [(100, torch.bfloat16), (12, torch.bfloat16),
                                     (6, torch.float32), (0, torch.bfloat16),
                                     (twa.LN_MAX_WIDTH[torch.bfloat16] + 8, torch.bfloat16),
                                     (twa.LN_MAX_WIDTH[torch.float32] + 4, torch.float32),
                                     (64, torch.float16)])
def test_check_ln_shape_refuses_widths_the_chunks_do_not_take(c, dtype):
    """Rows that are no whole 16-byte chunks (C % 8 in bf16, C % 4 in fp32),
    no rows, rows past the largest lane group, and other dtypes."""
    with pytest.raises(ValueError, match="16-byte chunks|unsupported dtype"):
        twa.check_ln_shape(c, dtype)


def test_check_ln_shape_message_names_the_width():
    with pytest.raises(ValueError, match=r"bf16 LayerNorm kernels take rows of whole 16-byte "
                                         r"chunks of 8 values.*got 100 values"):
        twa.check_ln_shape(100, torch.bfloat16, "layernorm_rows")


@pytest.mark.parametrize("c", [96, 192])
def test_layernorm_rows_matches_jax_kernel_at_width(c):
    """K10b: ``layernorm_rows`` vs the Pallas ``_ln_kernel`` (fused_layernorm)."""
    f = _f(np.random.default_rng(30 + c))
    x, lw, lb = f(2, 40, c) * 3 - 1, 1 + f(c, sc=0.1), f(c, sc=0.1)
    with interpret(jwa):
        ref = jwa.fused_layernorm(jnp.asarray(x), lw, lb, eps=1e-5)
    out = twa.layernorm_rows(_t(x), _t(lw), _t(lb), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(8, 12), (13, 21)], ids=["even", "odd"])
@pytest.mark.parametrize("c", [96, 192])
def test_patch_merge_matches_jax_fused_ln_linear(c, hw):
    """K10a on the stage map: ``patch_merge`` vs the Pallas ``_lnlin_kernel``
    (fused_ln_linear) on the rows gathered as the JAX PatchMerging gathers
    them (x0, x1, x2, x3 of each 2x2 neighbourhood; an odd edge zero-padded,
    its zeros in the statistics)."""
    h, w = hw
    b, out_dim = (2 if h % 2 == 0 else 1), 2 * c
    f = _f(np.random.default_rng(40 + c + h))
    x = f(b, h, w, c) * 2 + 0.5
    lw, lb, wt = 1 + f(4 * c, sc=0.1), f(4 * c, sc=0.1), f(out_dim, 4 * c, sc=(4 * c) ** -0.5)
    xp = np.pad(x, ((0, 0), (0, h % 2), (0, w % 2), (0, 0)))
    rows = np.concatenate([xp[:, 0::2, 0::2], xp[:, 1::2, 0::2], xp[:, 0::2, 1::2],
                           xp[:, 1::2, 1::2]], axis=-1).reshape(b, -1, 4 * c)
    with interpret(jwa):
        ref = jwa.fused_ln_linear(jnp.asarray(rows), lw, lb, jnp.asarray(wt.T), eps=1e-5)
    out = twa.patch_merge(_t(x), _t(lw), _t(lb), _t(wt), eps=1e-5)
    assert out.shape == (b, (h + 1) // 2, (w + 1) // 2, out_dim)
    np.testing.assert_allclose(out.numpy().reshape(b, -1, out_dim), np.asarray(ref),
                               atol=ATOL, rtol=0)
