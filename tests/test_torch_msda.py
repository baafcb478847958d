"""K3 and K6 (``grit_tpu_torch/ops/msda.py``) against the Pallas bodies they
replace, on the CPU, at the head layout of the shipped models.

Every shipped MSDA runs 8 heads of 64 channels over 4 levels of 4 points.
Inputs made with numpy from a seed go through ``msda`` (its plain version and
its autograd here) and through the JAX package's relaid entry
``ms_deform_attn_pallas_relaid`` with ``GRIT_MSDA_V5=1``, whose Pallas bodies
run in interpret mode as the JAX package's own tests run them
(tests/test_ops.py): the whole-slab ``_gather_matmul_kernel_v5`` (K3) and,
under ``jax.grad``, ``_gather_bwd_kernel_v4`` through ``_gather_bwd_v5`` (K6);
with ``GRIT_MSDA_CHUNKED=force`` the S-chunked ``_gather_matmul_kernel_v5s``
and ``_gather_bwd_kernel_v5s`` (K7a, K7b).  The pyramid is tiny and padded:
level sizes that are not multiples of 8 (the relay pads their rows),
locations that spill past [0, 1], and one image whose real rectangle is
smaller than the level at every level.  Tolerance: 2e-5 of each output's
max (the two sum corners, points and levels in other orders).

``check_msda_shape`` is the guard both CUDA wrappers call before a launch:
every MSDA shape of the shipped caption and detector configurations passes
it, and shapes the kernels do not take are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.ops import msda_pallas as jmp
from grit_tpu_torch.config import default_caption_config, default_detection_config
from grit_tpu_torch.ops import msda as tmsda
from test_torch_models import torch_one_thread  # noqa: F401
from test_torch_ops import interpret

HEADS, HEAD_DIM, POINTS = 8, 64, 4
LEVELS = ((5, 7), (3, 4), (2, 3), (1, 2))
BATCH, QUERIES = 2, 3
BODIES = {"K3 / K6 (v5)": "0", "K7a / K7b (v5s, S-chunked)": "force"}


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _rel(a, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(a) - ref).max() / max(np.abs(ref).max(), 1e-30))


def msda_inputs(seed=31):
    """value [N, S, 512], locations spilling past [0, 1], softmax weights,
    real_hw (image 1 smaller than every level), an output cotangent."""
    rng = np.random.default_rng(seed)
    c = HEADS * HEAD_DIM
    s = sum(h * w for h, w in LEVELS)
    value = rng.standard_normal((BATCH, s, c)).astype(np.float32)
    loc = (rng.random((BATCH, QUERIES, HEADS, len(LEVELS), POINTS, 2)) * 1.4 - 0.2)
    logits = rng.standard_normal((BATCH, QUERIES, HEADS, len(LEVELS) * POINTS))
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    real_hw = np.array([LEVELS] * BATCH, np.int32)
    real_hw[1] = [[max(h - 1, 1), max(w - 2, 1)] for h, w in LEVELS]
    cot = rng.standard_normal((BATCH, QUERIES, c)).astype(np.float32)
    return (value, loc.astype(np.float32),
            attn.reshape(BATCH, QUERIES, HEADS, len(LEVELS), POINTS).astype(np.float32),
            real_hw, cot)


def jax_msda(value, loc, attn, real_hw):
    """The JAX package's relaid MSDA on the natural [N, S, C] value."""
    relaid = jmp.relay_value(value, LEVELS)
    return jmp.ms_deform_attn_pallas_relaid(relaid, LEVELS, loc, attn,
                                            real_hw=jnp.asarray(real_hw))


@pytest.fixture
def pallas_v5(monkeypatch):
    """Select the v5 bodies; the test sets GRIT_MSDA_CHUNKED itself."""
    monkeypatch.setenv("GRIT_MSDA_V5", "1")
    return monkeypatch


@pytest.mark.parametrize("body", list(BODIES))
def test_msda_matches_pallas_forward(body, pallas_v5):
    """K3 against ``_gather_matmul_kernel_v5`` / ``_v5s`` in interpret mode."""
    pallas_v5.setenv("GRIT_MSDA_CHUNKED", BODIES[body])
    value, loc, attn, real_hw, _ = msda_inputs()
    assert jmp.needs_relay(LEVELS)
    with interpret(jmp):
        ref = jax_msda(jnp.asarray(value), loc, attn, real_hw)
    out = tmsda.msda(_t(value), LEVELS, _t(loc), _t(attn), _t(real_hw))
    assert out.shape == (BATCH, QUERIES, HEADS * HEAD_DIM)
    assert _rel(out.numpy(), ref) <= 2e-5


@pytest.mark.parametrize("body", list(BODIES))
def test_msda_gradients_match_pallas_backward(body, pallas_v5):
    """K6 (``msda``'s autograd) against jax.grad through the relaid entry,
    whose backward is ``_gather_bwd_kernel_v4`` (via ``_gather_bwd_v5``) or
    ``_gather_bwd_kernel_v5s`` in interpret mode: the value, location and
    weight gradients; the padded image's value outside its real rectangle
    gets none."""
    pallas_v5.setenv("GRIT_MSDA_CHUNKED", BODIES[body])
    value, loc, attn, real_hw, cot = msda_inputs()
    with interpret(jmp):
        ref = jax.grad(lambda v, l, a: (jax_msda(v, l, a, real_hw) * cot).sum(),
                       argnums=(0, 1, 2))(*map(jnp.asarray, (value, loc, attn)))
    leaves = [_t(a, grad=True) for a in (value, loc, attn)]
    out = tmsda.msda(leaves[0], LEVELS, leaves[1], leaves[2], _t(real_hw))
    (out * _t(cot)).sum().backward()
    for leaf, r, name in zip(leaves, ref, ("value", "locations", "weights")):
        assert _rel(leaf.grad.numpy(), r) <= 2e-5, name
    start = 0
    for (h, w), (rh, rw) in zip(LEVELS, real_hw[1]):
        dv = leaves[0].grad[1, start:start + h * w].reshape(h, w, -1)
        assert (dv[rh:] == 0).all() and (dv[:, rw:] == 0).all()
        start += h * w


def _pyramid(hw) -> list[tuple[int, int]]:
    """The deformable detector's levels at an input of ``hw``: strides 8 to 64."""
    return [(-(-hw[0] // st), -(-hw[1] // st)) for st in (8, 16, 32, 64)]


@pytest.mark.parametrize("which", ["caption 384x640", "detection 832x1344"])
def test_every_shipped_msda_shape_passes_the_guard(which):
    """Every MSDA shape of the shipped configurations, at their own image
    sizes and in both compute types, is one K3 and K6 take."""
    if which.startswith("caption"):
        config = default_caption_config()
        hw = tuple(config.dataset.transform_cfg.size)
    else:
        config = default_detection_config()
        hw = tuple(config.dataset.fixed_bucket)
    assert f"{hw[0]}x{hw[1]}" in which
    det = config.model.detector
    levels = _pyramid(hw)[:det.num_levels]
    s = sum(h * w for h, w in levels)
    for dtype in (torch.bfloat16, torch.float32):
        tmsda.check_msda_shape(s, det.d_model, det.num_heads, det.num_levels, det.num_points,
                               dtype, which)


@pytest.mark.parametrize("s,c,heads,levels,points,dtype", [
    (5100, 512, 8, 4, 4, torch.float16),      # no kernel in half precision
    (5100, 512, 7, 4, 4, torch.bfloat16),     # channels do not split into heads
    (5100, 96, 8, 4, 4, torch.bfloat16),      # 12-channel heads: not 4 x (8, 16, 32)
    (5100, 512, 32, 4, 4, torch.float32),     # 16-channel heads: 4 lanes a head
    (5100, 2048, 8, 4, 4, torch.float32),     # 256-channel heads: 64 lanes a head
    (5100, 512, 8, 4, 9, torch.bfloat16),     # 36 taps a head
    (4_300_000, 512, 8, 4, 4, torch.bfloat16),  # 2^31 values an image
])
def test_msda_guard_refuses_shapes_the_kernels_do_not_take(s, c, heads, levels, points, dtype):
    with pytest.raises(ValueError):
        tmsda.check_msda_shape(s, c, heads, levels, points, dtype)
