"""Decoder-only Deformable-DETR detection module, caption flavour.

Math parity: reference models/detection/det_module.py.  150 learned queries
(pos/tgt halves of one embedding, :136-139) run through ``num_layers``
decoder layers of [self-attention, multi-scale deformable cross-attention,
FFN] with iterative box refinement (:40-53); the module keeps
``num_layers + 1`` classification/box heads (clone 0 refines the initial
reference points, :106-112).  The sampling core is kernel K3
(``ops.msda.msda``) on the value in its natural [B, S, C] layout; pad
positions are masked through each image's per-level real extent instead of
a pre-mask pass over the value.  ``level_embed`` is kept for checkpoint
compatibility; the caption path does not use ``class_embed``, the detection
flavour's ``detection_head`` (:219-271) does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from grit_tpu_torch.models.layers import Dropout, Linear
from grit_tpu_torch.models.norm import LayerNorm
from grit_tpu_torch.ops import msda as msda_ops
from grit_tpu_torch.utils.boxes import inverse_sigmoid

LN_EPS = 1e-5


def msda_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Radial per-head offset init (ms_deform_attn.py:57-65)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MLP(nn.Module):
    """num_layers Linear layers with ReLU between (det_module.py:24-35)."""

    def __init__(self, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            Linear(hidden_dim, output_dim if i == num_layers - 1 else hidden_dim)
            for i in range(num_layers))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MSDeformAttnModule(nn.Module):
    """Query-conditioned multi-scale deformable attention layer."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.value_proj = Linear(d_model, d_model)
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = Linear(d_model, d_model)

    def forward(self, query, reference_points, src, spatial_shapes, real_hw):
        """query [B, Lq, C]; reference_points [B, Lq, L, 4] boxes (valid-ratio
        scaled); src [B, S, C]; real_hw [B, L, 2] per-image real level dims."""
        b, lq, _ = query.shape
        m, L, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(src)
        offsets = self.sampling_offsets(query).view(b, lq, m, L, p, 2)
        attn = torch.softmax(self.attention_weights(query).view(b, lq, m, L * p), -1)
        attn = attn.view(b, lq, m, L, p)
        loc = (reference_points[:, :, None, :, None, :2]
               + offsets / p * reference_points[:, :, None, :, None, 2:] * 0.5)
        out = msda_ops.msda(value, spatial_shapes, loc, attn, real_hw)
        return self.output_proj(out)


class SelfAttention(nn.Module):
    """torch nn.MultiheadAttention parity: packed in-proj QKV + out-proj."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.1):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)
        self.attn_drop = Dropout(dropout)

    def forward(self, q, k, v):
        b, n, c = q.shape
        h, d = self.n_heads, c // self.n_heads
        w, bias = self.in_proj_weight.to(q.dtype), self.in_proj_bias.to(q.dtype)
        qp = F.linear(q, w[:c], bias[:c]).view(b, -1, h, d).transpose(1, 2)
        kp = F.linear(k, w[c:2 * c], bias[c:2 * c]).view(b, -1, h, d).transpose(1, 2)
        vp = F.linear(v, w[2 * c:], bias[2 * c:]).view(b, -1, h, d).transpose(1, 2)
        p = self.attn_drop(torch.softmax(qp @ kp.transpose(-1, -2) / math.sqrt(d), dim=-1))
        return self.out_proj((p @ vp).transpose(1, 2).reshape(b, n, c))


class DeformableDecoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4, dropout: float = 0.1):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.self_attn = SelfAttention(d_model, n_heads, dropout)
        self.norm2 = LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points)
        self.norm1 = LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                valid_ratios, real_hw):
        # scale the reference boxes by per-level valid ratios (det_module.py:323-328)
        scale = torch.cat([valid_ratios, valid_ratios], -1)
        ref = reference_points[:, :, None] * scale[:, None]
        q = tgt + query_pos
        drop = self.dropout
        tgt = self.norm2(tgt + drop(self.self_attn(q, q, tgt)))
        ca = self.cross_attn(tgt + query_pos, ref, src, spatial_shapes, real_hw)
        tgt = self.norm1(tgt + drop(ca))
        return self.norm3(tgt + drop(self.linear2(drop(F.relu(self.linear1(tgt))))))


def get_valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """[B, H, W] pad mask -> [B, 2] (w, h) fractions of non-padded cols/rows."""
    _, h, w = mask.shape
    valid_h = (~mask[:, :, 0]).sum(1).float()
    valid_w = (~mask[:, 0, :]).sum(1).float()
    return torch.stack([valid_w / w, valid_h / h], -1)


class DetectionModule(nn.Module):
    def __init__(self, d_model: int = 512, n_heads: int = 8, num_layers: int = 6,
                 dim_feedforward: int = 1024, num_levels: int = 4, num_points: int = 4,
                 num_classes: int = 1849, num_queries: int = 150, dropout: float = 0.1):
        super().__init__()
        self.d_model, self.num_queries = d_model, num_queries
        self.query_embed = nn.Embedding(num_queries, 2 * d_model)
        self.level_embed = nn.Parameter(torch.zeros(num_levels, d_model))
        self.reference_points = Linear(d_model, 2)
        self.decoder_layers = nn.ModuleList(
            DeformableDecoderLayer(d_model, dim_feedforward, num_levels, n_heads, num_points,
                                   dropout)
            for _ in range(num_layers))
        self.class_embed = nn.ModuleList(
            Linear(d_model, num_classes) for _ in range(num_layers + 1))
        self.bbox_embed = nn.ModuleList(MLP(d_model, 4, 3) for _ in range(num_layers + 1))
        self.reset_head_parameters()

    @torch.no_grad()
    def reset_head_parameters(self, prior: float = 0.01) -> None:
        """The prediction heads' start (det_module.py:98-112): every class
        bias at the focal prior -log((1 - p) / p), and clone 0 of the box
        head, which refines the 2-d initial reference points, biased to
        small boxes (w, h logits -2)."""
        for head in self.class_embed:
            head.bias.fill_(-math.log((1 - prior) / prior))
        self.bbox_embed[0].layers[-1].bias.copy_(torch.tensor([0.0, 0.0, -2.0, -2.0]))

    @staticmethod
    def bbox_refine(bbox_embed: MLP, output, reference_points):
        """Iterative refinement with the reference's detach (det_module.py:40-53):
        no gradient reaches the boxes, so a layer's sampling locations learn
        through their offsets only."""
        tmp = bbox_embed(output)
        if reference_points.shape[-1] == 4:
            return torch.sigmoid(tmp + inverse_sigmoid(reference_points)).detach()
        xy = tmp[..., :2] + inverse_sigmoid(reference_points)
        return torch.sigmoid(torch.cat([xy, tmp[..., 2:]], -1)).detach()

    def forward(self, srcs, masks):
        """srcs: per level [B, H, W, C]; masks: per level [B, H, W] bool (True =
        pad).  Returns (hs [n_layers+1, B, Lq, C], init_ref, inter_refs)."""
        b = srcs[0].shape[0]
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        src_flat = torch.cat([s.reshape(b, -1, s.shape[-1]) for s in srcs], 1)
        valid_ratios = torch.stack([get_valid_ratio(m) for m in masks], 1)   # [B, L, 2]
        real_hw = torch.stack([
            torch.stack([(~m[:, :, 0]).sum(1), (~m[:, 0, :]).sum(1)], -1)
            for m in masks], 1).to(torch.int32)                              # [B, L, 2]

        # the embedding is an f32 parameter; the decoder computes in src's dtype
        query = self.query_embed.weight.to(src_flat.dtype)
        query_pos, query_tgt = query.split(self.d_model, dim=1)
        query_pos = query_pos[None].expand(b, -1, -1)
        query_tgt = query_tgt[None].expand(b, -1, -1)
        # the reference boxes, the valid ratios and so the sampling locations
        # stay f32 whatever the compute dtype (the JAX package rounds them to
        # it): every refinement takes the logit of the previous box, which
        # magnifies the rounding of a coordinate near 0 or 1
        reference_points = torch.sigmoid(self.reference_points(query_pos).float())
        reference_points = self.bbox_refine(self.bbox_embed[0], query_tgt, reference_points)

        tgt = query_tgt
        hs, refs = [tgt], [reference_points]
        for lid, layer in enumerate(self.decoder_layers):
            tgt = layer(tgt, query_pos, reference_points, src_flat, spatial_shapes,
                        valid_ratios, real_hw)
            reference_points = self.bbox_refine(self.bbox_embed[lid + 1], tgt,
                                                reference_points)
            hs.append(tgt)
            refs.append(reference_points)
        return torch.stack(hs), refs[0], torch.stack(refs)

    def detection_head(self, hs, init_reference, inter_references, *, training: bool) -> dict:
        """Per-layer class and box predictions (det_module.py:219-271): level
        ``lvl`` adds its box head's output to the logit of the reference it
        refined.  Training returns the last level as ``pred_logits`` /
        ``pred_boxes`` and the others as ``aux_outputs``; evaluation the last
        level only.  Boxes are f32 (cx, cy, w, h) in [0, 1]."""
        def level(lvl: int, reference) -> tuple[torch.Tensor, torch.Tensor]:
            reference = inverse_sigmoid(reference)
            tmp = self.bbox_embed[lvl](hs[lvl]).float()
            if reference.shape[-1] == 4:
                tmp = tmp + reference
            else:
                tmp = torch.cat([tmp[..., :2] + reference, tmp[..., 2:]], -1)
            return self.class_embed[lvl](hs[lvl]), torch.sigmoid(tmp)

        if not training:
            cls, box = level(hs.shape[0] - 1, inter_references[-2])
            return {"pred_logits": cls, "pred_boxes": box}
        outs = [level(lvl, init_reference if lvl == 0 else inter_references[lvl - 1])
                for lvl in range(hs.shape[0])]
        return {"pred_logits": outs[-1][0], "pred_boxes": outs[-1][1],
                "aux_outputs": [{"pred_logits": c, "pred_boxes": b} for c, b in outs[:-1]]}
