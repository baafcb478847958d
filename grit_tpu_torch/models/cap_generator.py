"""Autoregressive caption generator over dual visual features.

Math parity: reference models/caption/cap_generator.py, ``parallel`` decoder:
token embedding + position table, N post-LN layers of self-attention and two
cross-attentions (grid, region) fused by sigmoid gates, and a bias-free
output Linear + log_softmax.  The reference computes BOTH gates with
``fc_alpha1`` (cap_generator.py:48-49); ``replicate_alpha_bug`` (default
True) keeps that for checkpoint parity.  ``pos_emb`` is a loaded parameter:
the reference's init_weights overwrites the sinusoid table, so released
checkpoints carry their own.

- ``forward``: teacher forcing with a causal + pad mask;
- ``decode_step``: one token against fixed-shape KV caches, with the
  visual K/V projected once (``precompute_vis_kv``) and kept per image
  (``vis_fold`` = beam size).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from grit_tpu_torch.models.attention import FeedForward, MultiHeadAttention
from grit_tpu_torch.models.layers import Linear
from grit_tpu_torch.ops.posemb import sinusoid_encoding_table

DecodeCache = dict  # {'layers': [(k, v), ...], 'pad_hist': [B, T] bool}


class ParallelAttentionLayer(nn.Module):
    def __init__(self, d_model: int = 512, n_heads: int = 8, d_ff: int = 2048,
                 replicate_alpha_bug: bool = True, dropout: float = 0.1):
        super().__init__()
        self.replicate_alpha_bug = replicate_alpha_bug
        self.self_att = MultiHeadAttention(d_model, n_heads, dropout)
        self.vis_att1 = MultiHeadAttention(d_model, n_heads, dropout)
        self.vis_att2 = MultiHeadAttention(d_model, n_heads, dropout)
        self.fc_alpha1 = Linear(2 * d_model, d_model)
        self.fc_alpha2 = Linear(2 * d_model, d_model)
        self.pwff = FeedForward(d_model, d_ff, dropout)

    def _fuse(self, self_att, enc1, enc2, mask_pad):
        fc2 = self.fc_alpha1 if self.replicate_alpha_bug else self.fc_alpha2
        alpha1 = torch.sigmoid(self.fc_alpha1(torch.cat([self_att, enc1], -1)))
        alpha2 = torch.sigmoid(fc2(torch.cat([self_att, enc2], -1)))
        enc = (enc1 * alpha1 + enc2 * alpha2) / math.sqrt(2) * mask_pad
        return self.pwff(enc) * mask_pad

    def forward(self, x, y1, y2, mask_pad, mask_x, mask_y1, mask_y2):
        self_att = self.self_att(x, x, x, mask_x) * mask_pad
        enc1 = self.vis_att1(self_att, y1, y1, mask_y1) * mask_pad
        enc2 = self.vis_att2(self_att, y2, y2, mask_y2) * mask_pad
        return self._fuse(self_att, enc1, enc2, mask_pad)

    def precompute_vis_kv(self, y1, y2):
        return {"att1": self.vis_att1.attention.project_kv(y1, y1),
                "att2": self.vis_att2.attention.project_kv(y2, y2)}

    def decode(self, x, mask_pad, mask_x, mask_y1, mask_y2, cache, t, vis_kv, vis_fold=1):
        self_att, cache = self.self_att(x, x, x, mask_x, cache=cache, cache_index=t)
        self_att = self_att * mask_pad
        (k1, v1), (k2, v2) = vis_kv["att1"], vis_kv["att2"]
        enc1 = self.vis_att1(self_att, k1, v1, mask_y1, kv_projected=True,
                             kv_fold=vis_fold) * mask_pad
        enc2 = self.vis_att2(self_att, k2, v2, mask_y2, kv_projected=True,
                             kv_fold=vis_fold) * mask_pad
        return self._fuse(self_att, enc1, enc2, mask_pad), cache


class CaptionGenerator(nn.Module):
    def __init__(self, vocab_size: int, max_len: int, n_layers: int, pad_idx: int,
                 d_model: int = 512, n_heads: int = 8, d_ff: int = 2048,
                 replicate_alpha_bug: bool = True, dropout: float = 0.1):
        super().__init__()
        self.pad_idx, self.d_model = pad_idx, d_model
        #: set by ``captioner.to_compute_dtype``; None = the dtype of the weights
        self.compute_dtype = None
        self.word_emb = nn.Embedding(vocab_size, d_model)
        self.pos_emb = nn.Embedding(max_len + 1, d_model)
        with torch.no_grad():
            self.pos_emb.weight.copy_(sinusoid_encoding_table(max_len + 1, d_model, 0))
        self.layers = nn.ModuleList(
            ParallelAttentionLayer(d_model, n_heads, d_ff, replicate_alpha_bug, dropout)
            for _ in range(n_layers))
        self.fc = Linear(d_model, vocab_size, bias=False)

    @staticmethod
    def _vis(vis_inputs: dict):
        return (vis_inputs["gri_feat"], vis_inputs["reg_feat"],
                vis_inputs["gri_mask"], vis_inputs["reg_mask"])

    def forward(self, input_ids: torch.Tensor, vis_inputs: dict) -> torch.Tensor:
        """Teacher forcing: int [B, L] -> log-probs [B, L, V] (cap_generator.py:126-145)."""
        b, L = input_ids.shape
        dt = self._dtype()
        is_pad = input_ids == self.pad_idx
        mask_pad = (~is_pad)[..., None].to(dt)
        causal = torch.ones((L, L), dtype=torch.bool, device=input_ids.device).triu(1)
        mask_x = causal[None, None] | is_pad[:, None, None, :]
        seq = torch.arange(1, L + 1, device=input_ids.device)[None] * (~is_pad)
        x = (self.word_emb(input_ids) + self.pos_emb(seq)).to(dt)
        y1, y2, m1, m2 = self._vis(vis_inputs)
        for layer in self.layers:
            x = layer(x, y1, y2, mask_pad, mask_x, m1, m2)
        return torch.log_softmax(self.fc(x).float(), dim=-1)

    def _dtype(self) -> torch.dtype:
        """The embeddings stay f32 parameters; the layers compute in
        ``compute_dtype`` or, where none was set, in the dtype of their
        Linear weights."""
        return self.compute_dtype or self.fc.weight.dtype

    def init_cache(self, batch: int, t_max: int) -> DecodeCache:
        w = self.word_emb.weight

        def zeros():
            return torch.zeros((batch, t_max, self.d_model), dtype=self._dtype(),
                               device=w.device)

        return {"layers": [(zeros(), zeros()) for _ in self.layers],
                "pad_hist": torch.zeros((batch, t_max), dtype=torch.bool, device=w.device)}

    def precompute_vis_kv(self, vis_inputs: dict):
        y1, y2, _, _ = self._vis(vis_inputs)
        return [layer.precompute_vis_kv(y1, y2) for layer in self.layers]

    def decode_step(self, token: torch.Tensor, t: int, vis_inputs: dict, cache: DecodeCache,
                    *, vis_kv, vis_fold: int = 1):
        """One step: token int [B, 1] -> (log-probs [B, V], cache).  ``cache``
        is updated in place.  ``vis_fold=f``: token/cache are beam-expanded
        [B*f, ...] while vis_inputs/vis_kv stay per image [B, ...]."""
        is_pad = token == self.pad_idx
        dt = self._dtype()
        mask_pad = (~is_pad)[..., None].to(dt)
        pad_hist = cache["pad_hist"]
        pad_hist[:, t] = is_pad[:, 0]
        mask_x = pad_hist[:, None, None, :]
        x = (self.word_emb(token) + self.pos_emb.weight[t + 1]).to(dt)
        _, _, m1, m2 = self._vis(vis_inputs)
        layers = []
        for layer, layer_cache, kv in zip(self.layers, cache["layers"], vis_kv):
            x, layer_cache = layer.decode(x, mask_pad, mask_x, m1, m2, layer_cache, t, kv,
                                          vis_fold)
            layers.append(layer_cache)
        logits = self.fc(x)[:, 0]
        return torch.log_softmax(logits.float(), dim=-1), {"layers": layers,
                                                           "pad_hist": pad_hist}
