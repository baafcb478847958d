"""Attention library for the caption stack (reference models/common/attention.py).

- ``Attention``: scaled dot-product attention with ``kv_fold``: q has f times
  as many rows as k/v, and every f consecutive q rows (the beams of one
  image) attend to the same k/v row, so decode-time visual K/V stay
  per-image instead of beam-tiled.  The k/v are projected here unless
  ``kv_projected`` (the parallel decoder's K/V, projected once a batch); the
  sequential and concat decoders hand in the raw features at every step.
- ``MultiHeadAttention``: attention + dropout + post-LN residual
  ``LN(q + dropout(attn(q, k, v)))`` (attention.py:166-184), with an optional
  fixed-shape KV cache [B, T_max, D] written at ``cache_index``.
- ``FeedForward``: Linear-ReLU-Linear with post-LN residual.

Masks are boolean, True = masked out.  The learned memory slots of the
reference (``n_memories``) are not used by the GRIT captioner and are not
ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from grit_tpu_torch.models.layers import Dropout, Linear
from grit_tpu_torch.models.norm import LayerNorm

LN_EPS = 1e-5

KVCache = tuple[torch.Tensor, torch.Tensor]


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.1):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.attn_drop = Dropout(dropout)
        self.fc_q = Linear(d_model, d_model)
        self.fc_k = Linear(d_model, d_model)
        self.fc_v = Linear(d_model, d_model)
        self.fc_o = Linear(d_model, d_model)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None, *,
                kv_projected: bool = False, kv_fold: int = 1) -> torch.Tensor:
        h, d_k = self.n_heads, self.d_model // self.n_heads
        qh = self.fc_q(q)
        bq, nq = qh.shape[:2]
        b = bq // kv_fold
        kh, vh = (k, v) if kv_projected else (self.fc_k(k), self.fc_v(v))
        qh = qh.reshape(b, kv_fold * nq, h, d_k).transpose(1, 2)
        kh = kh.reshape(b, -1, h, d_k).transpose(1, 2)
        vh = vh.reshape(b, -1, h, d_k).transpose(1, 2)
        scores = qh @ kh.transpose(-1, -2) / math.sqrt(d_k)
        if mask is not None:
            scores = scores.masked_fill(mask, float("-inf"))
        out = self.attn_drop(torch.softmax(scores, dim=-1)) @ vh
        return self.fc_o(out.transpose(1, 2).reshape(bq, nq, self.d_model))

    def project_kv(self, k, v) -> KVCache:
        return self.fc_k(k), self.fc_v(v)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.1):
        super().__init__()
        self.attention = Attention(d_model, n_heads, dropout)
        self.drop = Dropout(dropout)
        self.layer_norm = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, queries, keys, values, mask=None, *, cache: Optional[KVCache] = None,
                cache_index: Optional[int] = None, kv_projected: bool = False,
                kv_fold: int = 1):
        """Returns the output, or (output, cache) when a cache is given.  With a
        cache, keys/values are the current token [B, 1, D]; their projections
        are written in place at ``cache_index`` and attention runs over the
        slots <= cache_index."""
        if cache is None:
            out = self.attention(queries, keys, values, mask,
                                 kv_projected=kv_projected, kv_fold=kv_fold)
            return self.layer_norm(queries + self.drop(out))
        k_cache, v_cache = cache
        k_new, v_new = self.attention.project_kv(keys, values)
        k_cache[:, cache_index] = k_new[:, 0]
        v_cache[:, cache_index] = v_new[:, 0]
        slot = torch.arange(k_cache.shape[1], device=k_cache.device) > cache_index
        full_mask = slot[None, None, None] if mask is None else mask | slot
        out = self.attention(queries, k_cache, v_cache, full_mask, kv_projected=True)
        return self.layer_norm(queries + self.drop(out)), (k_cache, v_cache)


class FeedForward(nn.Module):
    """Position-wise FFN with post-LN residual (pos_embed.py:34-48)."""

    def __init__(self, d_model: int = 512, d_ff: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.drop = Dropout(dropout)
        self.fc1 = Linear(d_model, d_ff)
        self.fc2 = Linear(d_ff, d_model)
        self.layer_norm = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x):
        return self.layer_norm(x + self.drop(self.fc2(self.drop(F.relu(self.fc1(x))))))
