"""Grid feature network: self-attention encoder over Swin grid tokens.

Math parity: reference models/caption/grid_net.py:9-42.  Input projection
1024 -> 512 with ReLU and LN, then ``n_layers`` post-LN transformer layers;
returns the per-layer outputs stacked on axis 1 (the captioner uses the last).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from grit_tpu_torch.models.attention import LN_EPS, FeedForward, MultiHeadAttention
from grit_tpu_torch.models.norm import LayerNorm


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int = 512, n_heads: int = 8, d_ff: int = 2048):
        super().__init__()
        self.mhatt = MultiHeadAttention(d_model, n_heads)
        self.pwff = FeedForward(d_model, d_ff)

    def forward(self, q, k, v, mask=None):
        return self.pwff(self.mhatt(q, k, v, mask))


class GridFeatureNetwork(nn.Module):
    def __init__(self, n_layers: int, d_in: int = 1024, d_model: int = 512,
                 n_heads: int = 8, d_ff: int = 2048):
        super().__init__()
        self.fc = nn.Linear(d_in, d_model)
        self.layer_norm = LayerNorm(d_model, eps=LN_EPS)
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, n_heads, d_ff) for _ in range(n_layers))

    def forward(self, x, mask=None):
        """x [B, S, d_in]; mask bool [B, 1, 1, S] -> ([B, n_layers, S, d_model], mask)."""
        out = self.layer_norm(F.relu(self.fc(x)))
        outs = []
        for layer in self.layers:
            out = layer(out, out, out, mask)
            outs.append(out)
        return torch.stack(outs, 1), mask
