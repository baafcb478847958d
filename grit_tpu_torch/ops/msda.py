"""Multi-scale deformable attention (MSDA), kernel K3.

``msda`` replaces the TPU's ``grit_tpu/ops/msda_pallas.py``
``_gather_matmul_kernel_v5`` (via ``ms_deform_attn_pallas_v5`` and
``msda.py::ms_deform_attn_relaid``).  On a CUDA tensor it launches the
hand-written gather in ``csrc/msda.cu`` (design notes there); on a CPU tensor
it runs ``msda_plain``, the level-by-level formulation of the reference's
python oracle (models/ops/functions/ms_deform_attn_func.py:41-61, i.e.
``F.grid_sample(align_corners=False, padding_mode='zeros')`` per level).

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
LAUNCHES = {"msda": 0}

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


def msda(value, spatial_shapes, sampling_locations, attention_weights,
         real_hw) -> torch.Tensor:
    """K3: MSDA forward (see module docstring).  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return msda_plain(value, spatial_shapes, sampling_locations,
                          attention_weights, real_hw)
    n, s, c = value.shape
    _, lq, m, L, p, _ = sampling_locations.shape
    dt = value.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"msda: unsupported dtype {dt}")
    if len(spatial_shapes) != L or s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"msda: value has {s} rows for levels {spatial_shapes}")
    if c % m:
        raise ValueError(f"msda: {c} channels do not split into {m} heads")
    _cuda.require(value, "value", dt)
    loc = sampling_locations.float().contiguous()
    attn = attention_weights.float().contiguous()
    _cuda.require(attn, "attention_weights", torch.float32, (n, lq, m, L, p))
    _cuda.require(loc, "sampling_locations", torch.float32, (n, lq, m, L, p, 2))
    rh = real_hw.to(device=value.device, dtype=torch.int32).contiguous()
    _cuda.require(rh, "real_hw", torch.int32, (n, L, 2))
    shapes = _shapes_tensor(spatial_shapes, value.device)
    lib = _cuda.library()
    out = torch.empty((n, lq, c), dtype=dt, device=value.device)
    _cuda.check(lib.grit_msda(value.data_ptr(), shapes.data_ptr(), loc.data_ptr(),
                              attn.data_ptr(), rh.data_ptr(),
                              out.data_ptr(), n, s, lq, m, c // m, L, p,
                              _cuda.DTYPE_CODE[dt], _cuda.stream()),
                "msda")
    LAUNCHES["msda"] += 1
    return out
