"""Autoregressive caption generator over dual visual features.

Math parity: reference models/caption/cap_generator.py: token embedding +
position table, N post-LN layers, and a bias-free output Linear +
log_softmax.  Three layer variants (``decoder_name``), as grit_tpu:

- ``parallel`` (default): self-attention, then two cross-attentions (grid,
  region) fused by sigmoid gates.  The reference computes BOTH gates with
  ``fc_alpha1`` (cap_generator.py:48-49); ``replicate_alpha_bug`` (default
  True) keeps that for checkpoint parity;
- ``sequential``: self-attention, grid cross-attention, region
  cross-attention, FFN, one after the other;
- ``concat``: one cross-attention over the grid and region features
  concatenated.  The reference's concat branch reads a key that never exists
  (``vis_inputs['grid_feat']``, cap_generator.py:151); here, as in grit_tpu,
  it works on the concatenated features and masks (``_vis``).

``pos_emb`` is a loaded parameter: the reference's init_weights overwrites
the sinusoid table, so released checkpoints carry their own.

- ``forward``: teacher forcing with a causal + pad mask;
- ``decode_step``: one token against fixed-shape KV caches, the visual
  inputs kept per image (``vis_fold`` = beam size; the cross-attentions fold
  the beams into their query rows).  The parallel layers take their visual
  K/V projected once (``precompute_vis_kv``); after its self-attention a
  parallel layer's decode step is one call of
  ``ops.decode_layer.fused_decode_layer_tail`` (kernel K11) whenever no
  dropout is live and the tensors are on the GPU (``use_fused_tail``); with
  live dropout it runs module by module, as grit_tpu's deterministic-only
  fused tail.  The sequential and concat layers project the visual K/V at
  every step, as grit_tpu's do, module by module.

Tensor parallel (``parallel.mesh.shard_model``): a layer's ``pwff`` holds
this rank's d_ff slice (``FeedForward``'s split path), and a parallel layer's
fused decode step becomes K11's split (``fused_decode_layer_tail_tp``: the
partial entry, the f32 all-reduce, the finish entry).  Where the vocab head
is split (vocab 10201 is odd: under tp2 it stays whole, as in grit_tpu), its
logits are gathered (``gather_from_tp``) before ``log_softmax``, so every rank
of the tensor group scores the same log-probs and its beam search chooses the
same beams.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from grit_tpu_torch.models.attention import LN_EPS, FeedForward, MultiHeadAttention
from grit_tpu_torch.models.layers import Dropout, Linear
from grit_tpu_torch.ops import decode_layer
from grit_tpu_torch.ops.posemb import sinusoid_encoding_table
from grit_tpu_torch.parallel.tensor import copy_to_tp, gather_from_tp

DecodeCache = dict  # {'layers': [(k, v), ...], 'pad_hist': [B, T] bool}


def use_fused_tail(layer: "ParallelAttentionLayer", x: torch.Tensor) -> bool:
    """Whether ``layer.decode`` takes K11 for its tail: on CUDA tensors, unless
    a dropout of the layer is live (``train()`` mode with a rate above 0)."""
    return x.is_cuda and not layer.dropout_live()


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

    def dropout_live(self) -> bool:
        return self.training and any(m.p > 0.0 for m in self.modules()
                                     if isinstance(m, Dropout))

    def tail_weights(self, dtype: torch.dtype) -> tuple:
        """The 24 weights of the decode tail in ``ops.decode_layer``'s order,
        read from the submodules the module path uses: matrices as ``[in,
        out]`` views of the Linear weights in ``dtype`` (a cast only where the
        parameters are f32 masters), LayerNorm parameters f32; the second gate
        from ``fc_alpha1`` under ``replicate_alpha_bug``.  Under tensor
        parallelism fc1 / fc2 (and fc1's bias) are this rank's slices."""
        d = self.fc_alpha1.out_features

        def wb(lin):
            return lin.weight.to(dtype).t(), lin.bias.to(dtype)

        def cross(mha):
            return (*wb(mha.attention.fc_q), *wb(mha.attention.fc_o),
                    mha.layer_norm.weight, mha.layer_norm.bias)

        def gate(lin):
            w = lin.weight.to(dtype)
            return w[:, :d].t(), w[:, d:].t(), lin.bias.to(dtype)

        gate2 = self.fc_alpha1 if self.replicate_alpha_bug else self.fc_alpha2
        return (*cross(self.vis_att1), *cross(self.vis_att2), *gate(self.fc_alpha1),
                *gate(gate2), *wb(self.pwff.fc1), *wb(self.pwff.fc2),
                self.pwff.layer_norm.weight, self.pwff.layer_norm.bias)

    def decode(self, x, y1, y2, mask_pad, mask_x, mask_y1, mask_y2, cache, t, vis_kv=None,
               vis_fold=1):
        """``vis_kv``: ``precompute_vis_kv``'s output; projected here when None."""
        self_att, cache = self.self_att(x, x, x, mask_x, cache=cache, cache_index=t)
        self_att = self_att * mask_pad
        if vis_kv is None:
            vis_kv = self.precompute_vis_kv(y1, y2)
        (k1, v1), (k2, v2) = vis_kv["att1"], vis_kv["att2"]
        if use_fused_tail(self, self_att):
            kw = dict(fold=vis_fold, n_heads=self.vis_att1.attention.n_heads, eps=LN_EPS)
            weights = self.tail_weights(self_att.dtype)
            if self.pwff.tp_group is not None:
                out = decode_layer.fused_decode_layer_tail_tp(
                    self_att, k1, v1, mask_y1, k2, v2, mask_y2, mask_pad, weights,
                    group=self.pwff.tp_group, **kw)
            else:
                out = decode_layer.fused_decode_layer_tail(
                    self_att, k1, v1, mask_y1, k2, v2, mask_y2, mask_pad, weights, **kw)
            return out, cache
        enc1 = self.vis_att1(self_att, k1, v1, mask_y1, kv_projected=True,
                             kv_fold=vis_fold) * mask_pad
        enc2 = self.vis_att2(self_att, k2, v2, mask_y2, kv_projected=True,
                             kv_fold=vis_fold) * mask_pad
        return self._fuse(self_att, enc1, enc2, mask_pad), cache


class SequentialAttentionLayer(nn.Module):
    def __init__(self, d_model: int = 512, n_heads: int = 8, d_ff: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.self_att = MultiHeadAttention(d_model, n_heads, dropout)
        self.vis_att1 = MultiHeadAttention(d_model, n_heads, dropout)
        self.vis_att2 = MultiHeadAttention(d_model, n_heads, dropout)
        self.pwff = FeedForward(d_model, d_ff, dropout)

    def _tail(self, out, y1, y2, mask_pad, mask_y1, mask_y2, vis_fold=1):
        out = self.vis_att1(out, y1, y1, mask_y1, kv_fold=vis_fold) * mask_pad
        out = self.vis_att2(out, y2, y2, mask_y2, kv_fold=vis_fold) * mask_pad
        return self.pwff(out) * mask_pad

    def forward(self, x, y1, y2, mask_pad, mask_x, mask_y1, mask_y2):
        out = self.self_att(x, x, x, mask_x) * mask_pad
        return self._tail(out, y1, y2, mask_pad, mask_y1, mask_y2)

    def decode(self, x, y1, y2, mask_pad, mask_x, mask_y1, mask_y2, cache, t, vis_kv=None,
               vis_fold=1):
        out, cache = self.self_att(x, x, x, mask_x, cache=cache, cache_index=t)
        return self._tail(out * mask_pad, y1, y2, mask_pad, mask_y1, mask_y2, vis_fold), cache


class ConcatAttentionLayer(nn.Module):
    """One cross-attention over the concatenated [grid; region] features,
    which ``CaptionGenerator._vis`` hands in as ``y1`` / ``mask_y1``."""

    def __init__(self, d_model: int = 512, n_heads: int = 8, d_ff: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.self_att = MultiHeadAttention(d_model, n_heads, dropout)
        self.vis_att = MultiHeadAttention(d_model, n_heads, dropout)
        self.pwff = FeedForward(d_model, d_ff, dropout)

    def _tail(self, out, y1, mask_pad, mask_y1, vis_fold=1):
        out = self.vis_att(out, y1, y1, mask_y1, kv_fold=vis_fold) * mask_pad
        return self.pwff(out) * mask_pad

    def forward(self, x, y1, y2, mask_pad, mask_x, mask_y1, mask_y2):
        out = self.self_att(x, x, x, mask_x) * mask_pad
        return self._tail(out, y1, mask_pad, mask_y1)

    def decode(self, x, y1, y2, mask_pad, mask_x, mask_y1, mask_y2, cache, t, vis_kv=None,
               vis_fold=1):
        out, cache = self.self_att(x, x, x, mask_x, cache=cache, cache_index=t)
        return self._tail(out * mask_pad, y1, mask_pad, mask_y1, vis_fold), cache


GENERATOR_LAYER = {
    "parallel": ParallelAttentionLayer,
    "sequential": SequentialAttentionLayer,
    "concat": ConcatAttentionLayer,
}


class CaptionGenerator(nn.Module):
    #: set by ``parallel.mesh.shard_model`` where ``fc`` holds this rank's
    #: vocab columns
    tp_group = None

    def __init__(self, vocab_size: int, max_len: int, n_layers: int, pad_idx: int,
                 d_model: int = 512, n_heads: int = 8, d_ff: int = 2048,
                 replicate_alpha_bug: bool = True, dropout: float = 0.1,
                 decoder_name: str = "parallel"):
        super().__init__()
        if decoder_name not in GENERATOR_LAYER:
            raise ValueError(f"decoder_name {decoder_name!r}: not one of {list(GENERATOR_LAYER)}")
        self.pad_idx, self.d_model, self.decoder_name = pad_idx, d_model, decoder_name
        #: set by ``captioner.to_compute_dtype``; None = the dtype of the weights
        self.compute_dtype = None
        self.word_emb = nn.Embedding(vocab_size, d_model)
        self.pos_emb = nn.Embedding(max_len + 1, d_model)
        with torch.no_grad():
            self.pos_emb.weight.copy_(sinusoid_encoding_table(max_len + 1, d_model, 0))
        kwargs = dict(d_model=d_model, n_heads=n_heads, d_ff=d_ff, dropout=dropout)
        if decoder_name == "parallel":
            kwargs["replicate_alpha_bug"] = replicate_alpha_bug
        self.layers = nn.ModuleList(GENERATOR_LAYER[decoder_name](**kwargs)
                                    for _ in range(n_layers))
        self.fc = Linear(d_model, vocab_size, bias=False)

    def _vis(self, vis_inputs: dict):
        if self.decoder_name == "concat":
            y = torch.cat([vis_inputs["gri_feat"], vis_inputs["reg_feat"]], 1)
            mask = torch.cat([vis_inputs["gri_mask"], vis_inputs["reg_mask"]], 3)
            return y, y, mask, mask
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
        return torch.log_softmax(self.logits(x).float(), dim=-1)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The vocab head; where it is split, each rank's columns gathered."""
        if self.tp_group is None:
            return self.fc(x)
        return gather_from_tp(self.fc(copy_to_tp(x, self.tp_group)), self.tp_group)

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
        """Per-layer projected visual K/V of the parallel decoder; None for
        the others, which project at every step."""
        if self.decoder_name != "parallel":
            return None
        y1, y2, _, _ = self._vis(vis_inputs)
        return [layer.precompute_vis_kv(y1, y2) for layer in self.layers]

    def decode_step(self, token: torch.Tensor, t: int, vis_inputs: dict, cache: DecodeCache,
                    *, vis_kv=None, vis_fold: int = 1):
        """One step: token int [B, 1] -> (log-probs [B, V], cache).  ``cache``
        is updated in place.  ``vis_fold=f``: token/cache are beam-expanded
        [B*f, ...] while vis_inputs/vis_kv stay per image [B, ...].
        ``vis_kv``: ``precompute_vis_kv``'s output, or None."""
        is_pad = token == self.pad_idx
        dt = self._dtype()
        mask_pad = (~is_pad)[..., None].to(dt)
        pad_hist = cache["pad_hist"]
        pad_hist[:, t] = is_pad[:, 0]
        mask_x = pad_hist[:, None, None, :]
        x = (self.word_emb(token) + self.pos_emb.weight[t + 1]).to(dt)
        y1, y2, m1, m2 = self._vis(vis_inputs)
        layers = []
        for i, (layer, layer_cache) in enumerate(zip(self.layers, cache["layers"])):
            x, layer_cache = layer.decode(x, y1, y2, mask_pad, mask_x, m1, m2, layer_cache, t,
                                          None if vis_kv is None else vis_kv[i], vis_fold)
            layers.append(layer_cache)
        logits = self.logits(x)[:, 0]
        return torch.log_softmax(logits.float(), dim=-1), {"layers": layers,
                                                           "pad_hist": pad_hist}
