"""Swin block kernels K1 (attention half-block) and K2 (MLP half-block).

``block_step`` replaces the TPU's ``grit_tpu/ops/window_attention.py``
``_band_kernel`` (via ``fused_block_step`` / ``fused_block_mlp_step``), and
``mlp`` its ``_mlp_kernel`` (via ``fused_mlp``).  On a CUDA tensor each
launches the hand-written kernels in ``csrc/swin_block.cu`` (design notes
there); on a CPU tensor each runs its plain version, ``block_step_plain`` /
``mlp_plain``, which define the dtype semantics the kernels reproduce:
f32 LN statistics with var = E[x^2] - mu^2, f32 matmul accumulation, q scaled
before rounding to the storage type, softmax probabilities rounded to the
storage type before the value product, exact-erf GELU, residuals added in f32.

Unlike the TPU path, the map is never rolled: the block takes and returns the
padded map [B, Hp, Wp, C] in unshifted coordinates, and the kernels fold the
shift into their addresses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from grit_tpu_torch.ops import _cuda
from grit_tpu_torch.ops.window import (relative_position_index,
                                       shifted_window_mask, window_partition,
                                       window_reverse)

LN_EPS = 1e-5

#: Kernel launches per wrapper (one per call that reached the CUDA kernels).
LAUNCHES = {"block_step": 0, "mlp": 0}

_EPI_BIAS, _EPI_GELU, _EPI_RESID, _EPI_RESID_MAP = 0, 1, 2, 3


def _ln_fast(xf: torch.Tensor, w, b, eps: float) -> torch.Tensor:
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def _pad_mask(hp: int, wp: int, real_hw, shift: int, device) -> torch.Tensor:
    """[Hp, Wp, 1] bool: True on window-padding tokens, in coordinates of the
    map rolled by -shift."""
    y = (torch.arange(hp, device=device) + shift) % hp
    x = (torch.arange(wp, device=device) + shift) % wp
    return ((y[:, None] >= real_hw[0]) | (x[None, :] >= real_hw[1]))[..., None]


def block_step_plain(x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b, table, *,
                     num_heads: int, window: int, real_hw, shift: int = 0,
                     eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of K1: x + proj(W-MSA(LN1(x))) on the padded map.

    x: [B, Hp, Wp, C]; tokens outside ``real_hw`` are window padding (zero
    before the LN statistics and after the affine; no residual).  Linear
    weights in torch layout [out, in]; ``table``: [(2w-1)^2, heads].
    Output at padding tokens is unspecified (finite).  The kernels take the
    Linear weights and biases in x's dtype and the norm parameters and the
    table in f32, as ``models.captioner.to_compute_dtype`` stores them.
    """
    b, hp, wp, c = x.shape
    d = c // num_heads
    n = window * window
    dt = x.dtype
    xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    pad = _pad_mask(hp, wp, real_hw, shift, x.device)
    xf = xs.float().masked_fill(pad, 0.0)
    xn = _ln_fast(xf, norm_w, norm_b, eps).masked_fill(pad, 0.0).to(dt)
    xw = window_partition(xn, window).float()                       # [BW, N, C]
    qkv = F.linear(xw, qkv_w.float(), qkv_b.float())
    q = (qkv[..., :c] * d ** -0.5).to(dt).float()
    k = qkv[..., c:2 * c].to(dt).float()
    v = qkv[..., 2 * c:].to(dt).float()

    def heads(t):
        return t.reshape(t.shape[0], n, num_heads, d).transpose(1, 2)

    s = heads(q) @ heads(k).transpose(-1, -2)                        # [BW, h, N, N]
    idx = relative_position_index(window, x.device)
    s = s + table.float()[idx.reshape(-1)].reshape(n, n, num_heads).permute(2, 0, 1)
    if shift:
        mask = shifted_window_mask(hp, wp, window, shift, x.device)  # [nW, N, N]
        s = (s.reshape(b, -1, num_heads, n, n) + mask[None, :, None]).reshape(s.shape)
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = (p @ heads(v)).transpose(1, 2).reshape(-1, n, c).to(dt).float()
    y = F.linear(o, proj_w.float(), proj_b.float())
    y = window_reverse(y, window, hp, wp) + xf
    y = y.to(dt)
    return torch.roll(y, (shift, shift), (1, 2)) if shift else y


def block_step(x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b, table, *,
               num_heads: int, window: int, real_hw, shift: int = 0,
               eps: float = LN_EPS) -> torch.Tensor:
    """K1: one Swin attention half-block on the padded map (see
    ``block_step_plain``).  CPU tensors run the plain version; CUDA tensors
    launch the kernels or raise."""
    if x.device.type == "cpu":
        return block_step_plain(
            x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b, table,
            num_heads=num_heads, window=window, real_hw=real_hw, shift=shift, eps=eps)
    b, hp, wp, c = x.shape
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"block_step: unsupported dtype {dt}")
    if c != 32 * num_heads:
        raise ValueError(f"block_step: head dim must be 32, got {c}/{num_heads}")
    if hp % window or wp % window or window * window > 256:
        raise ValueError(f"block_step: map {hp}x{wp} does not tile windows of {window}")
    if c % 64:  # the GEMM tiles: N % 64, K % 32
        raise ValueError(f"block_step: channels {c} not a multiple of 64")
    for t, name, t_dt, shape in (
            (x, "x", dt, None), (qkv_w, "qkv_w", dt, (3 * c, c)), (qkv_b, "qkv_b", dt, (3 * c,)),
            (proj_w, "proj_w", dt, (c, c)), (proj_b, "proj_b", dt, (c,)),
            (norm_w, "norm_w", torch.float32, (c,)), (norm_b, "norm_b", torch.float32, (c,)),
            (table, "table", torch.float32, ((2 * window - 1) ** 2, num_heads))):
        _cuda.require(t, name, t_dt, shape)
    lib = _cuda.library()
    code = _cuda.DTYPE_CODE[dt]
    st = _cuda.stream()
    rows = b * hp * wp
    geo = (hp, wp, window, shift, int(real_hw[0]), int(real_hw[1]))

    xn = torch.empty((rows, c), dtype=dt, device=x.device)
    _cuda.check(lib.grit_ln_rows(x.data_ptr(), norm_w.data_ptr(), norm_b.data_ptr(),
                                 xn.data_ptr(), rows, c, 1, *geo, eps, code, st),
                "block_step ln1")
    qkv = torch.empty((rows, 3 * c), dtype=dt, device=x.device)
    _cuda.check(lib.grit_gemm(xn.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(),
                              qkv.data_ptr(), None, rows, 3 * c, c, _EPI_BIAS,
                              (c // num_heads) ** -0.5, c, *geo, code, st),
                "block_step qkv")
    ao = xn  # same shape; xn is dead once qkv exists
    _cuda.check(lib.grit_window_attn(qkv.data_ptr(), table.data_ptr(), ao.data_ptr(),
                                     rows // (window * window), c, num_heads,
                                     hp, wp, window, shift, code, st),
                "block_step attention")
    out = torch.empty_like(x)
    _cuda.check(lib.grit_gemm(ao.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(),
                              out.data_ptr(), x.data_ptr(), rows, c, c, _EPI_RESID_MAP,
                              1.0, 0, *geo, code, st),
                "block_step proj")
    LAUNCHES["block_step"] += 1
    return out


def mlp_plain(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, *,
              eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of K2: rows [R, C] -> x + fc2(GELU(fc1(LN(x))))."""
    dt = x.dtype
    xf = x.float()
    xn = _ln_fast(xf, norm_w, norm_b, eps).to(dt).float()
    h = F.linear(xn, fc1_w.float(), fc1_b.float())
    h = (h * 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))).to(dt).float()
    return (xf + F.linear(h, fc2_w.float(), fc2_b.float())).to(dt)


def mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, *,
        eps: float = LN_EPS) -> torch.Tensor:
    """K2: the Swin MLP half-block with its residual on rows [R, C] (see
    ``mlp_plain``).  CPU tensors run the plain version; CUDA tensors launch
    the kernels or raise."""
    if x.device.type == "cpu":
        return mlp_plain(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps=eps)
    rows, c = x.shape
    hid = fc1_w.shape[0]
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"mlp: unsupported dtype {dt}")
    if c % 64 or hid % 64:
        raise ValueError(f"mlp: widths {c}/{hid} not multiples of 64")
    for t, name, t_dt, shape in (
            (x, "x", dt, None), (fc1_w, "fc1_w", dt, (hid, c)), (fc1_b, "fc1_b", dt, (hid,)),
            (fc2_w, "fc2_w", dt, (c, hid)), (fc2_b, "fc2_b", dt, (c,)),
            (norm_w, "norm_w", torch.float32, (c,)), (norm_b, "norm_b", torch.float32, (c,))):
        _cuda.require(t, name, t_dt, shape)
    lib = _cuda.library()
    code = _cuda.DTYPE_CODE[dt]
    st = _cuda.stream()
    geo = (1, 1, 1, 0, 1, 1)  # unused in row mode
    xn = torch.empty_like(x)
    _cuda.check(lib.grit_ln_rows(x.data_ptr(), norm_w.data_ptr(), norm_b.data_ptr(),
                                 xn.data_ptr(), rows, c, 0, *geo, eps, code, st),
                "mlp ln2")
    h = torch.empty((rows, hid), dtype=dt, device=x.device)
    _cuda.check(lib.grit_gemm(xn.data_ptr(), fc1_w.data_ptr(), fc1_b.data_ptr(),
                              h.data_ptr(), None, rows, hid, c, _EPI_GELU, 1.0, 0,
                              *geo, code, st),
                "mlp fc1")
    out = torch.empty_like(x)
    _cuda.check(lib.grit_gemm(h.data_ptr(), fc2_w.data_ptr(), fc2_b.data_ptr(),
                              out.data_ptr(), x.data_ptr(), rows, c, hid, _EPI_RESID,
                              1.0, 0, *geo, code, st),
                "mlp fc2")
    LAUNCHES["mlp"] += 1
    return out
