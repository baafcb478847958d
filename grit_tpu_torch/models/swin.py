"""Swin Transformer backbone (GRIT flavour), reference models/common/swin_model.py.

Every stage ends in a PatchMerging, the last one projecting to ``pos_dim``
instead of doubling (swin_model.py:315, :600), which yields an extra H/64
map.  The backbone returns four NHWC maps: stage-2/3/4 outputs and the
extra merged map (:659-671).

Each stage pads its map once to window multiples and keeps it padded
through its blocks; a block is K1 (``ops.window_attention.block_step``: LN1,
window attention with the block's shift, projection, residual) then K2
(``ops.window_attention.mlp``) over all padded rows.  Padding tokens are
masked inside K1 and sliced off at stage exit.  The patch embed and
PatchMerging are plain convolution / LayerNorm / Linear.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from grit_tpu_torch.models.norm import LayerNorm
from grit_tpu_torch.ops import window_attention as wa

LN_EPS = 1e-5

# backbone presets, as grit_tpu.models.swin.BACKBONES
BACKBONES = {
    "swin_base_win7_384_22k": dict(embed_dim=128, depths=(2, 2, 18, 2),
                                   num_heads=(4, 8, 16, 32), window=12, pos_dim=1024),
    "swin_test": dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window=4, pos_dim=64),
}


class WindowAttention(nn.Module):
    """Parameter holder: qkv, proj and the relative-position bias table."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads, self.window, self.shift = num_heads, window, shift
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        """x: [B, Hp, Wp, C] padded map whose real extent is ``hw``."""
        a = self.attn
        x = wa.block_step(
            x, self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
            a.proj.weight, a.proj.bias, a.relative_position_bias_table,
            num_heads=self.num_heads, window=self.window, real_hw=hw,
            shift=self.shift, eps=LN_EPS)
        b, hp, wp, c = x.shape
        rows = wa.mlp(x.reshape(b * hp * wp, c), self.norm2.weight, self.norm2.bias,
                      self.mlp.fc1.weight, self.mlp.fc1.bias,
                      self.mlp.fc2.weight, self.mlp.fc2.bias, eps=LN_EPS)
        return rows.reshape(b, hp, wp, c)


class PatchMerging(nn.Module):
    """2x2 token merge: LN(4C) then Linear(4C -> out_dim, no bias)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, ceil(H/2), ceil(W/2), out_dim]."""
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, out_dim: int, depth: int, num_heads: int, window: int):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2)
            for i in range(depth))
        self.downsample = PatchMerging(dim, out_dim)

    def forward(self, x: torch.Tensor):
        """[B, H, W, C] -> (stage output [B, H, W, C], merged map)."""
        h, w = x.shape[1:3]
        pad_b = (self.window - h % self.window) % self.window
        pad_r = (self.window - w % self.window) % self.window
        xp = F.pad(x, (0, 0, 0, pad_r, 0, pad_b)) if pad_b or pad_r else x.contiguous()
        for blk in self.blocks:
            xp = blk(xp, (h, w))
        x = xp[:, :h, :w]
        return x, self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, H/p, W/p, C]."""
        x = self.proj(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x)


class SwinTransformer(nn.Module):
    """GRIT Swin backbone; returns 4 NHWC feature maps (strides 8/16/32/64)."""

    def __init__(self, embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 12,
                 patch_size: int = 4, pos_dim: int = 1024):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pos_dim = pos_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        n = len(depths)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i,
                       pos_dim if i == n - 1 else embed_dim * 2 ** (i + 1),
                       depths[i], num_heads[i], window)
            for i in range(n))

    @property
    def num_channels(self) -> list[int]:
        return [self.embed_dim * 2 ** i for i in range(1, len(self.depths))] + [self.pos_dim]

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """images: [B, H, W, 3] float, H and W multiples of 64."""
        x = self.patch_embed(images.to(self.patch_embed.proj.weight.dtype))
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, x = layer(x)
            if i > 0:
                outs.append(x_out)
        outs.append(x)
        return outs


def build_swin(name: str = "swin_base_win7_384_22k") -> SwinTransformer:
    return SwinTransformer(**BACKBONES[name])
