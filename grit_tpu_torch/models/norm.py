"""Norm layers with flax's mixed-precision semantics.

The scale and bias stay f32 whatever the compute dtype
(``captioner.to_compute_dtype`` never casts them).  A bf16 input is
normalised in f32, statistics and affine both, and the result is rounded back
to the input's dtype, as flax's ``LayerNorm``/``GroupNorm(dtype=bf16)`` do.
For an f32 input both casts are no-ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)
