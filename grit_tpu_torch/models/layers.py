"""Linear, convolution and dropout layers with flax's training semantics.

``Linear`` and ``Conv2d`` cast weight and bias to the input's dtype at every
call, inside the graph, as flax's ``Dense``/``Conv(dtype=...)`` do.  A model
whose parameters were rounded once for inference
(``captioner.to_compute_dtype``) pays nothing for it; a training model keeps
f32 master parameters, computes in bf16, and gets f32 gradients back through
the cast.

``Dropout`` and ``drop_path`` draw from an explicit ``torch.Generator`` (set
on every module that has a ``generator`` attribute by
``captioner.GRITCaptioner.set_generator``; ``None`` means torch's global
generator), so a training step is reproducible from its generator's seed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Dropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``): identity in ``eval()`` or at rate 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, shard: Optional[tuple[int, int]] = None) -> torch.Tensor:
        """``shard=(i, n)``: ``x`` is the i-th of n equal slices of the last
        dim of a whole tensor (a tensor-parallel rank's columns); the mask is
        drawn for the whole tensor and sliced, so that the ranks draw what one
        process draws and their generators stay in step."""
        if not self.training or self.p == 0.0:
            return x
        shape = x.shape if shard is None else (*x.shape[:-1], x.shape[-1] * shard[1])
        keep = torch.rand(shape, device=x.device, generator=self.generator) >= self.p
        if shard is not None:
            keep = keep.chunk(shard[1], -1)[shard[0]]
        return torch.where(keep, x / (1.0 - self.p), 0.0)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def draw_keep(batch: int, rate: float, device, generator) -> torch.Tensor:
    """Per-sample keep mask [B] of stochastic depth at drop rate ``rate``."""
    return torch.rand(batch, device=device, generator=generator) >= rate


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Stochastic depth (timm semantics): zero the branch of the samples
    whose ``keep`` is False and scale the others by 1 / (1 - rate).
    ``keep=None`` is the identity."""
    if keep is None:
        return x
    mask = keep.reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(mask, x / (1.0 - rate), 0.0)


def set_generator(module: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Draw every dropout and drop-path mask under ``module`` from
    ``generator`` (None: torch's global generator)."""
    for mod in module.modules():
        if hasattr(mod, "generator"):
            mod.generator = generator
    return module
