"""Swin Transformer backbone (GRIT flavour), reference models/common/swin_model.py.

Every stage ends in a PatchMerging, the last one projecting to ``pos_dim``
instead of doubling (swin_model.py:315, :600), which yields an extra H/64
map.  The backbone returns four NHWC maps: stage-2/3/4 outputs and the
extra merged map (:659-671).

In ``eval()``, and in a frozen stage, each stage pads its map once to window
multiples and keeps it padded through its blocks; a block is K1
(``ops.window_attention.block_step``: LN1, window attention with the block's
shift, projection, residual) then K2 (``ops.window_attention.mlp``) over all
padded rows.  Padding tokens are masked inside K1 and sliced off at stage
exit.

In ``train()`` a block of a stage that trains works on the unpadded map, as
the JAX package's gradient path does: plain LN1, zero padding, K4
(``block_attention_train``, differentiable through K5), crop, drop-path and
residual, then K2 on the unpadded rows, which returns the branch alone when
drop-path is active.  ``frozen_stages`` follows the reference's
``_freeze_stages`` (swin_model.py:622-637): ``fs >= 0`` freezes the patch
embed, ``fs >= 2`` stages ``0 .. fs-2``; frozen parts run as in ``eval()``
without a graph.  ``use_checkpoint`` recomputes each training block in the
backward (``torch.utils.checkpoint``).  The patch embed is a plain
convolution, then K10b (``ops.window_attention.layernorm_rows``); every
PatchMerging is K10a (``ops.window_attention.patch_merge``: the 2x2 gather,
LayerNorm over 4C and the reduction), in ``eval()`` and in ``train()`` alike.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from grit_tpu_torch.models.layers import Conv2d, Linear, draw_keep, drop_path
from grit_tpu_torch.models.norm import LayerNorm
from grit_tpu_torch.ops import window_attention as wa
from grit_tpu_torch.parallel.tensor import copy_to_tp, reduce_from_tp

LN_EPS = 1e-5

# backbone presets, as grit_tpu.models.swin.BACKBONES (the reference's size
# menu).  All have head dim 32.  A caption model on another preset than base
# needs model.grid_feat_dim set to its pos_dim (large 1536, small and tiny
# 768, nano 512), as the JAX config does not derive it either
BACKBONES = {
    "swin_base_win7_384_22k": dict(embed_dim=128, depths=(2, 2, 18, 2),
                                   num_heads=(4, 8, 16, 32), window=12, pos_dim=1024,
                                   drop_path_rate=0.3),
    "swin_large_win7_384_22k": dict(embed_dim=192, depths=(2, 2, 18, 2),
                                    num_heads=(6, 12, 24, 48), window=12, pos_dim=1536,
                                    drop_path_rate=0.3),
    "swin_small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), window=7,
                       pos_dim=768, drop_path_rate=0.3),
    "swin_tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window=7,
                      pos_dim=768, drop_path_rate=0.2),
    "swin_nano": dict(embed_dim=64, depths=(2, 2, 6, 2), num_heads=(2, 4, 8, 16), window=7,
                      pos_dim=512, drop_path_rate=0.2),
    "swin_test": dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window=4, pos_dim=64,
                      drop_path_rate=0.0),
}


class WindowAttention(nn.Module):
    """Parameter holder: qkv, proj and the relative-position bias table."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))


class Mlp(nn.Module):
    """fc1 and fc2 of a block's MLP.  ``tp_group`` (set by
    ``parallel.mesh.shard_model``): fc1 holds this rank's hidden columns and
    fc2 the matching input rows, and ``SwinBlock._mlp`` runs K2 on them."""

    tp_group = None

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.num_heads, self.window, self.shift = num_heads, window, shift
        self.drop_path_rate = float(drop_path_rate)
        self.generator = None   # drop-path draws; see layers.py
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _mlp(self, rows: torch.Tensor, residual: bool) -> torch.Tensor:
        dt = rows.dtype
        m = self.mlp
        group = m.tp_group
        if group is None:
            return wa.mlp(rows, self.norm2.weight, self.norm2.bias,
                          m.fc1.weight.to(dt), m.fc1.bias.to(dt),
                          m.fc2.weight.to(dt), m.fc2.bias.to(dt), eps=LN_EPS, residual=residual)
        # tensor parallel: K2 on this rank's hidden units gives its partial in
        # the compute type; the f32 sum over the ranks, fc2's bias and the
        # residual, rounded once.  The inputs' gradients (rows, LN2's scale
        # and bias) are the ranks' partials summed by copy_to_tp
        part = wa.mlp(copy_to_tp(rows, group), copy_to_tp(self.norm2.weight, group),
                      copy_to_tp(self.norm2.bias, group), m.fc1.weight.to(dt),
                      m.fc1.bias.to(dt), m.fc2.weight.to(dt), None, eps=LN_EPS,
                      residual=False)
        return self.mlp_finish(rows, reduce_from_tp(part, group), residual)

    def mlp_finish(self, rows: torch.Tensor, y: torch.Tensor, residual: bool) -> torch.Tensor:
        """The sum ``y`` (f32) of the ranks' K2 partials + fc2's bias (+ the
        rows), rounded once to the rows' dtype."""
        y = y + self.mlp.fc2.bias.to(rows.dtype).float()
        return (y + rows.float() if residual else y).to(rows.dtype)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        """Eval / frozen path.  x: [B, Hp, Wp, C] padded map whose real extent
        is ``hw``."""
        a = self.attn
        dt = x.dtype
        x = wa.block_step(
            x, self.norm1.weight, self.norm1.bias, a.qkv.weight.to(dt), a.qkv.bias.to(dt),
            a.proj.weight.to(dt), a.proj.bias.to(dt), a.relative_position_bias_table,
            num_heads=self.num_heads, window=self.window, real_hw=hw,
            shift=self.shift, eps=LN_EPS)
        b, hp, wp, c = x.shape
        return self._mlp(x.reshape(b * hp * wp, c), True).reshape(b, hp, wp, c)

    def draw_keeps(self, batch: int, device):
        """This call's two drop-path keep masks, or None when drop-path is off.
        Drawn outside ``forward_train`` so that a checkpointed block sees the
        same masks when it is recomputed."""
        if self.drop_path_rate == 0.0:
            return None
        return (draw_keep(batch, self.drop_path_rate, device, self.generator),
                draw_keep(batch, self.drop_path_rate, device, self.generator))

    def forward_train(self, x: torch.Tensor, keeps=None) -> torch.Tensor:
        """Gradient path.  x: [B, H, W, C] unpadded map."""
        b, h, w, c = x.shape
        a = self.attn
        dt = x.dtype
        win = self.window
        pad_b, pad_r = (win - h % win) % win, (win - w % win) % win
        xn = self.norm1(x)
        if pad_b or pad_r:
            xn = F.pad(xn, (0, 0, 0, pad_r, 0, pad_b))
        y = wa.block_attention_train(
            xn.contiguous(), a.qkv.weight.to(dt), a.qkv.bias.to(dt), a.proj.weight.to(dt),
            a.proj.bias.to(dt), a.relative_position_bias_table,
            num_heads=self.num_heads, window=win, shift=self.shift)
        keep1, keep2 = keeps if keeps is not None else (None, None)
        x = x + drop_path(y[:, :h, :w], keep1, self.drop_path_rate)
        # with drop-path the kernel returns the branch and the residual is added here
        out = self._mlp(x.reshape(b * h * w, c), keeps is None).reshape(b, h, w, c)
        return out if keeps is None else x + drop_path(out, keep2, self.drop_path_rate)


class PatchMerging(nn.Module):
    """2x2 token merge: LN(4C) then Linear(4C -> out_dim, no bias)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Linear(4 * dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, ceil(H/2), ceil(W/2), out_dim]."""
        return wa.patch_merge(x.contiguous(), self.norm.weight, self.norm.bias,
                              self.reduction.weight.to(x.dtype), eps=LN_EPS)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, out_dim: int, depth: int, num_heads: int, window: int,
                 drop_path_rates: Sequence[float] = (), use_checkpoint: bool = False):
        super().__init__()
        self.window = window
        self.use_checkpoint = use_checkpoint
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2,
                      drop_path_rate=drop_path_rates[i] if len(drop_path_rates) else 0.0)
            for i in range(depth))
        self.downsample = PatchMerging(dim, out_dim)

    def forward(self, x: torch.Tensor):
        """[B, H, W, C] -> (stage output [B, H, W, C], merged map)."""
        if self.training:
            for blk in self.blocks:
                keeps = blk.draw_keeps(x.shape[0], x.device)
                if self.use_checkpoint:
                    x = checkpoint(blk.forward_train, x, keeps, use_reentrant=False)
                else:
                    x = blk.forward_train(x, keeps)
            return x, self.downsample(x)
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
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, H/p, W/p, C]."""
        x = self.proj(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return wa.layernorm_rows(x.contiguous(), self.norm.weight, self.norm.bias, eps=LN_EPS)


class SwinTransformer(nn.Module):
    """GRIT Swin backbone; returns 4 NHWC feature maps (strides 8/16/32/64)."""

    def __init__(self, embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 12,
                 patch_size: int = 4, pos_dim: int = 1024, drop_path_rate: float = 0.0,
                 frozen_stages: int = -1, use_checkpoint: bool = False):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pos_dim = pos_dim
        self.frozen_stages = frozen_stages
        #: set by ``captioner.to_compute_dtype``; None = the dtype of the weights
        self.compute_dtype = None
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        n = len(depths)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i,
                       pos_dim if i == n - 1 else embed_dim * 2 ** (i + 1),
                       depths[i], num_heads[i], window,
                       drop_path_rates=dpr[sum(depths[:i]):sum(depths[:i + 1])],
                       use_checkpoint=use_checkpoint)
            for i in range(n))
        self.train(self.training)

    def _frozen(self) -> list[nn.Module]:
        fs = self.frozen_stages
        return ([self.patch_embed] if fs >= 0 else []) + list(self.layers[:max(0, fs - 1)])

    def train(self, mode: bool = True):
        """Frozen parts stay in ``eval()`` (swin_model.py:631-637)."""
        super().train(mode)
        for mod in self._frozen():
            mod.eval()
        return self

    @property
    def num_channels(self) -> list[int]:
        return [self.embed_dim * 2 ** i for i in range(1, len(self.depths))] + [self.pos_dim]

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """images: [B, H, W, 3] float, H and W multiples of 64."""
        images = images.to(self.compute_dtype or self.patch_embed.proj.weight.dtype)
        frozen = self._frozen()
        with torch.no_grad() if self.patch_embed in frozen else contextlib.nullcontext():
            x = self.patch_embed(images)
        outs = []
        for i, layer in enumerate(self.layers):
            with torch.no_grad() if layer in frozen else contextlib.nullcontext():
                x_out, x = layer(x)
            if i > 0:
                outs.append(x_out)
        outs.append(x)
        return outs


def build_swin(name: str = "swin_base_win7_384_22k", **overrides) -> SwinTransformer:
    return SwinTransformer(**{**BACKBONES[name], **overrides})
