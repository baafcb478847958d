"""The benchmark's random weights, made on the device from ``--seed``.

One uniform draw in [-1, 1) for all parameters together, scaled per
parameter by one element-wise product:

- matrices and tensors of more than one axis: Xavier-uniform over the
  tensor viewed as [shape[0], -1];
- biases: 0.02 times the draw; norm scales: 1 + 0.1 times the draw (a norm
  whose bias is exactly zero maps a zero row of padding to an all-zero row,
  which no trained model has);
- the published model's special starts (Deformable DETR's and GRIT's): the
  deformable attention's offsets at their radial pattern and zero offset
  and weight matrices, the class heads' bias at the focal prior 0.01, every
  box head's last layer at zero (each refinement starts as the identity)
  but for the first box head's size bias at -2, the caption decoder's
  sinusoid position table.

The program and the reference are handed the same float32 tensors.
"""

from __future__ import annotations

import math
import re

import torch


def _radial_offsets(heads: int, levels: int, points: int) -> torch.Tensor:
    theta = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, levels, points, 1)
    grid = grid * torch.arange(1, points + 1, dtype=torch.float32)[None, None, :, None]
    return grid.reshape(-1)


def _sinusoid(n: int, d: int) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32)[None]
    angle = pos / torch.pow(torch.tensor(10000.0), 2 * dim / d)
    out = torch.zeros(n, d)
    out[:, 0::2] = torch.sin(angle)
    out[:, 1::2] = torch.cos(angle)
    out[0] = 0.0
    return out


def _scale_and_shift(name: str, shape) -> tuple[float, float]:
    if len(shape) > 1:
        fan_out = shape[0]
        fan_in = math.prod(shape[1:])
        return math.sqrt(6.0 / (fan_in + fan_out)), 0.0
    if name.endswith(".bias") or name.endswith("_bias"):
        return 0.02, 0.0
    return 0.1, 1.0


def make_weights(named_shapes: list[tuple[str, tuple]], seed: int, device,
                 det: dict | None = None) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for the parameters
    ``named_shapes`` (in that order), drawn from ``seed``.  ``det`` gives the
    deformable attention's heads, levels and points for its offset start."""
    counts = [math.prod(s) for _, s in named_shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(counts), generator=gen, device=device) * 2.0 - 1.0
    ss = torch.tensor([_scale_and_shift(n, s) for n, s in named_shapes], device=device)
    reps = torch.tensor(counts, device=device)
    flat = flat * ss[:, 0].repeat_interleave(reps) + ss[:, 1].repeat_interleave(reps)
    out = dict(zip((n for n, _ in named_shapes),
                   (t.view(s) for t, (_, s) in zip(flat.split(counts), named_shapes))))
    with torch.no_grad():
        for name, t in out.items():
            if re.search(r"\.sampling_offsets\.bias$", name):
                t.copy_(_radial_offsets(det["num_heads"], det["num_levels"], det["num_points"]))
            elif re.search(r"\.(sampling_offsets|attention_weights)\.weight$", name):
                t.zero_()
            elif re.search(r"\.class_embed\.\d+\.bias$", name):
                t.fill_(-math.log((1 - 0.01) / 0.01))
            elif re.search(r"\.bbox_embed\.0\.layers\.2\.bias$", name):
                t.copy_(torch.tensor([0.0, 0.0, -2.0, -2.0]))
            elif re.search(r"\.bbox_embed\.\d+\.layers\.2\.(weight|bias)$", name):
                t.zero_()
            elif name.endswith("pos_emb.weight"):
                t.copy_(_sinusoid(*t.shape))
    return out
