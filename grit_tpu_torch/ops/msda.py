"""Multi-scale deformable attention (MSDA): kernel K3 and its backward K6.

``msda`` replaces the TPU's ``grit_tpu/ops/msda_pallas.py``
``_gather_matmul_kernel_v5`` (via ``ms_deform_attn_pallas_v5`` and
``msda.py::ms_deform_attn_relaid``) and the S-chunked
``_gather_matmul_kernel_v5s`` (K7a), which computes the same function for
pyramids too large for the TPU's on-chip slab: the gather here reads the
value from device memory and has no such limit, so there is nothing to chunk.
``msda_bwd`` replaces ``_gather_bwd_kernel_v4`` (via ``_gather_bwd_v5`` /
``_gather_bwd_v4``) and the S-chunked ``_gather_bwd_kernel_v5s`` (K7b), and
also the chain from corner weights to locations and attention weights that
the TPU path leaves to autodiff.  The TPU's earlier generations map onto the
same two kernels: ``_gather_matmul_kernel`` (K13a) and
``_gather_matmul_kernel_v3`` (K13c, both via ``ms_deform_attn_pallas``) and
``_gather_matmul_kernel_v4`` (K13d, via ``ms_deform_attn_pallas_relaid``
with ``GRIT_MSDA_V5=0``) onto ``msda``; ``_gather_bwd_kernel`` (K13b) onto
``msda_bwd``.  They differ from v5 in how the value slab is laid out for the
TPU's matrix unit (head-major with aligned level spans, a relaid slab with
head pairs) and in how the one-hot selection is built; the GPU gathers the
four corners by address from the natural ``[N, S, M*D]`` layout, so no relay
layout, span alignment or head pairing exists to distinguish them.  On a CUDA tensor each launches the
hand-written kernel in ``csrc/msda.cu`` (design notes there) or raises; on a
CPU tensor it runs ``msda_plain``, the level-by-level formulation of the
reference's python oracle (models/ops/functions/ms_deform_attn_func.py:41-61,
i.e. ``F.grid_sample(align_corners=False, padding_mode='zeros')`` per level),
or its autograd.  ``msda`` is differentiable in value, locations and weights.

Shapes (reference models/ops/modules/ms_deform_attn.py:80-89), value in its
natural projection layout:
  value:               [N, S, M*D]   S = sum_l H_l * W_l
  spatial_shapes:      L (H, W) ints
  sampling_locations:  [N, Lq, M, L, P, 2], (x, y) normalized to [0, 1]
  attention_weights:   [N, Lq, M, L, P], softmax-normalized over L*P
  real_hw:             [N, L, 2] int (h, w) real extent of each level
  output:              [N, Lq, M*D]
Taps outside an image's real rectangle read zero, exactly as if the padded
value positions had been zeroed.
"""

from __future__ import annotations

from typing import Sequence

import torch

from grit_tpu_torch.ops import _cuda

#: Kernel launches (one per call that reached the CUDA kernel).
LAUNCHES = {"msda": 0, "msda_bwd": 0}

#: What K3 and K6 (``csrc/msda.cu``) take: a lane owns ``MSDA_VEC``
#: consecutive channels of a head, ``MSDA_LANES`` lanes a head; a group's
#: taps (levels x points) are set up in shared memory, at most
#: ``MSDA_MAX_TAPS``; offsets within one image's value map are 32-bit.
MSDA_VEC, MSDA_LANES, MSDA_MAX_TAPS = 4, (8, 16, 32), 32

_SHAPES_CACHE: dict = {}


def level_start_index(spatial_shapes: Sequence[tuple[int, int]]) -> list[int]:
    starts, acc = [], 0
    for h, w in spatial_shapes:
        starts.append(acc)
        acc += h * w
    return starts


def msda_plain(value, spatial_shapes, sampling_locations, attention_weights,
               real_hw) -> torch.Tensor:
    """Plain version of K3 (f32 accumulation, output in value's dtype)."""
    n, _, c = value.shape
    _, lq, m, _, p, _ = sampling_locations.shape
    d = c // m
    loc = sampling_locations.float()
    attn = attention_weights.float()
    n_idx = torch.arange(n, device=value.device)[:, None, None, None]
    m_idx = torch.arange(m, device=value.device)[None, None, :, None]
    out = torch.zeros((n, lq, m, d), dtype=torch.float32, device=value.device)
    for lid, ((h, w), st) in enumerate(zip(spatial_shapes, level_start_index(spatial_shapes))):
        val = value[:, st:st + h * w].float().reshape(n, h * w, m, d)
        hmax = torch.clamp(real_hw[:, lid, 0].to(value.device), max=h)[:, None, None, None]
        wmax = torch.clamp(real_hw[:, lid, 1].to(value.device), max=w)[:, None, None, None]
        px = loc[:, :, :, lid, :, 0] * w - 0.5          # [N, Lq, M, P]
        py = loc[:, :, :, lid, :, 1] * h - 0.5
        x0, y0 = torch.floor(px), torch.floor(py)
        lx, ly = px - x0, py - y0
        x0, y0 = x0.long(), y0.long()
        interp = torch.zeros((n, lq, m, p, d), dtype=torch.float32, device=value.device)
        for dx, dy, wgt in ((0, 0, (1 - lx) * (1 - ly)), (1, 0, lx * (1 - ly)),
                            (0, 1, (1 - lx) * ly), (1, 1, lx * ly)):
            ix, iy = x0 + dx, y0 + dy
            valid = (ix >= 0) & (ix < wmax) & (iy >= 0) & (iy < hmax)
            flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            sampled = val[n_idx, flat, m_idx]             # [N, Lq, M, P, D]
            interp = interp + sampled * torch.where(valid, wgt, 0.0)[..., None]
        out = out + (interp * attn[:, :, :, lid, :, None]).sum(3)
    return out.reshape(n, lq, c).to(value.dtype)


def _shapes_tensor(spatial_shapes, device) -> torch.Tensor:
    key = (tuple(spatial_shapes), str(device))
    if key not in _SHAPES_CACHE:
        rows = [(h, w, st) for (h, w), st in
                zip(spatial_shapes, level_start_index(spatial_shapes))]
        _SHAPES_CACHE[key] = torch.tensor(rows, dtype=torch.int32, device=device)
    return _SHAPES_CACHE[key]


def check_msda_shape(s: int, c: int, heads: int, levels: int, points: int, dtype,
                     what: str = "msda") -> None:
    """Raise ``ValueError`` unless K3 and K6 take a value map of ``s`` rows of
    ``c`` channels in ``heads`` heads, sampled at ``levels`` x ``points``
    taps, in ``dtype``: a head width of ``MSDA_VEC`` channels times one of
    ``MSDA_LANES`` (so C % 4 == 0), at most ``MSDA_MAX_TAPS`` taps, fewer
    than 2^31 values an image, fp32 or bf16.  Both wrappers check a call
    with this before they launch."""
    if dtype not in _cuda.DTYPE_CODE:
        raise ValueError(f"{what}: unsupported dtype {dtype}")
    if c % heads or (c // heads) % MSDA_VEC or (c // heads) // MSDA_VEC not in MSDA_LANES:
        raise ValueError(f"{what}: {c} channels in {heads} heads: a head needs "
                         f"{MSDA_VEC} x {MSDA_LANES} channels")
    if levels * points > MSDA_MAX_TAPS:
        raise ValueError(f"{what}: {levels} levels x {points} points exceed "
                         f"{MSDA_MAX_TAPS} taps")
    if s * c >= 2 ** 31:
        raise ValueError(f"{what}: {s} rows of {c} channels exceed 32-bit offsets")


def _check(name, value, spatial_shapes, sampling_locations, attention_weights, real_hw):
    """Validate a CUDA call's arguments -> (loc f32, attn f32, real_hw i32, shapes)."""
    n, s, c = value.shape
    _, lq, m, L, p, _ = sampling_locations.shape
    dt = value.dtype
    check_msda_shape(s, c, m, L, p, dt, name)
    if len(spatial_shapes) != L or s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"{name}: value has {s} rows for levels {spatial_shapes}")
    _cuda.require(value, "value", dt)
    loc = sampling_locations.float().contiguous()
    attn = attention_weights.float().contiguous()
    _cuda.require(attn, "attention_weights", torch.float32, (n, lq, m, L, p))
    _cuda.require(loc, "sampling_locations", torch.float32, (n, lq, m, L, p, 2))
    rh = real_hw.to(device=value.device, dtype=torch.int32).contiguous()
    _cuda.require(rh, "real_hw", torch.int32, (n, L, 2))
    return loc, attn, rh, _shapes_tensor(spatial_shapes, value.device)


def _msda_forward(value, spatial_shapes, sampling_locations, attention_weights, real_hw):
    if value.device.type == "cpu":
        return msda_plain(value, spatial_shapes, sampling_locations,
                          attention_weights, real_hw)
    n, s, c = value.shape
    _, lq, m, L, p, _ = sampling_locations.shape
    loc, attn, rh, shapes = _check("msda", value, spatial_shapes, sampling_locations,
                                   attention_weights, real_hw)
    lib = _cuda.library()
    out = torch.empty((n, lq, c), dtype=value.dtype, device=value.device)
    _cuda.check(lib.grit_msda(value.data_ptr(), shapes.data_ptr(), loc.data_ptr(),
                              attn.data_ptr(), rh.data_ptr(),
                              out.data_ptr(), n, s, lq, m, c // m, L, p,
                              _cuda.DTYPE_CODE[value.dtype], _cuda.stream()),
                "msda")
    LAUNCHES["msda"] += 1
    return out


def msda_bwd_plain(dout, value, spatial_shapes, sampling_locations, attention_weights,
                   real_hw):
    """Plain version of K6, by autograd of ``msda_plain``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (value, sampling_locations, attention_weights)]
        out = msda_plain(leaves[0], spatial_shapes, leaves[1], leaves[2], real_hw)
        return torch.autograd.grad(out, leaves, dout.to(out.dtype))


def msda_bwd(dout, value, spatial_shapes, sampling_locations, attention_weights, real_hw):
    """K6: MSDA backward -> (dvalue [N, S, C] in value's dtype, dlocations
    [N, Lq, M, L, P, 2], dweights [N, Lq, M, L, P], each in its input's
    dtype).  The value gradient is scattered with vector f32 atomics into a
    zeroed f32 buffer (rounded once for bf16), so it is reproducible to f32
    summation order; the location and weight gradients are the same bit for
    bit from call to call; a tap outside the level or the image's real extent
    gets no gradient.  CPU tensors run the plain version; CUDA tensors launch
    the kernel (shapes as ``check_msda_shape`` takes them) or raise."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return msda_bwd_plain(dout, value, spatial_shapes, sampling_locations,
                              attention_weights, real_hw)
    n, s, c = value.shape
    _, lq, m, L, p, _ = sampling_locations.shape
    d = c // m
    loc, attn, rh, shapes = _check("msda_bwd", value, spatial_shapes, sampling_locations,
                                   attention_weights, real_hw)
    dout = dout.to(value.dtype).contiguous()
    _cuda.require(dout, "dout", value.dtype, (n, lq, c))
    lib = _cuda.library()
    dvalue = torch.zeros((n, s, c), dtype=torch.float32, device=value.device)
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    _cuda.check(lib.grit_msda_bwd(value.data_ptr(), shapes.data_ptr(), loc.data_ptr(),
                                  attn.data_ptr(), rh.data_ptr(), dout.data_ptr(),
                                  dvalue.data_ptr(), dloc.data_ptr(), dattn.data_ptr(),
                                  n, s, lq, m, d, L, p, _cuda.DTYPE_CODE[value.dtype],
                                  _cuda.stream()),
                "msda_bwd")
    LAUNCHES["msda_bwd"] += 1
    return (dvalue.to(value.dtype), dloc.to(sampling_locations.dtype),
            dattn.to(attention_weights.dtype))


class _MsdaFn(torch.autograd.Function):
    """K3 forward, K6 backward."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, real_hw, spatial_shapes):
        ctx.save_for_backward(value, sampling_locations, attention_weights, real_hw)
        ctx.spatial_shapes = spatial_shapes
        return _msda_forward(value, spatial_shapes, sampling_locations, attention_weights,
                             real_hw)

    @staticmethod
    def backward(ctx, dout):
        value, loc, attn, real_hw = ctx.saved_tensors
        dvalue, dloc, dattn = msda_bwd(dout, value, ctx.spatial_shapes, loc, attn, real_hw)
        return dvalue, dloc, dattn, None, None


def msda(value, spatial_shapes, sampling_locations, attention_weights,
         real_hw) -> torch.Tensor:
    """K3: MSDA forward (see module docstring), differentiable through K6.
    CPU tensors run the plain version; CUDA tensors launch the kernel or raise."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return _MsdaFn.apply(value, sampling_locations, attention_weights, real_hw,
                         spatial_shapes)
