"""A DeepSeek-V3-family language model as a caption decoder (``decoder_name
= "mla_moe"``): multi-head latent attention (MLA) and a mixture of experts
with shared experts, as Kimi-VL-A3B-Instruct's language model has them.

The layer equations are those of the public DeepSeek-V3 modelling code
(``modeling_deepseek.py``: ``DeepseekV3RMSNorm``, ``DeepseekV3Attention``,
``MoEGate``, ``DeepseekV3MoE``, ``DeepseekV3MLP``), for ``q_lora_rank``
null, no rope scaling, ``scoring_func="sigmoid"`` with ``topk_method=
"noaux_tc"`` and one expert group:

- RMSNorm: ``w * x / sqrt(mean(x^2) + eps)`` in f32, rounded back to the
  input's type (the scale stays f32, as the port's other norms);
- RoPE on the last ``qk_rope_head_dim`` channels of q and of the shared key,
  in DeepSeek-V3's form: the channel pairs (2i, 2i + 1) de-interleaved to
  (i, d/2 + i), then rotated by halves, at ``theta = rope_theta``;
- MLA: ``q = W_q x`` per head [nope | rope]; the latent ``c = RMSNorm(W_kva
  x)[:kv_lora_rank]`` and the shared rope key from the rest of ``W_kva x``;
  ``[k_nope | v] = W_kvb c`` per head; softmax((q_nope k_nope + q_rope k_rope)
  / sqrt(nope + rope)) v, then ``W_o``;
- router: ``s = sigmoid(W_g x)`` in f32; the top ``k`` of ``s + b`` (the
  correction bias chooses but does not weight); the chosen ``s`` normalised
  to sum 1 (``norm_topk_prob``) and times ``routed_scaling_factor``;
- experts: SwiGLU ``W_d (silu(W_gate x) * W_up x)``, the routed ones through
  ``ops.moe`` (rows sorted by expert, two grouped GEMMs), the shared ones as
  one SwiGLU of ``n_shared_experts`` times the expert width;
- layer: ``x += MLA(RMSNorm(x)); x += MLP(RMSNorm(x))``; the first
  ``first_k_dense_replace`` layers have a dense SwiGLU, the rest experts.

Precision: the residual stream ``x`` is carried in f32 and each branch reads
it normalised in the compute type (bf16 on the card), whose products,
latents and caches are in that type; norms, rope, softmaxes, the router and
the experts' sums are f32.  (At bf16 a residual stream rounded at each of
the 54 additions doubles the prefill's error against a float32 forward,
measured at the published widths.)

Two attention paths, one set of weights:

- ``forward`` (prefill, teacher forcing): a whole causal sequence,
  un-absorbed: K and V expanded from the latent by ``W_kvb``;
- ``decode``: one token a row against the latents kept so far, absorbed:
  ``W_kvb``'s key half folded into the query (``q_nope W_uk`` is 512 wide),
  the scores taken against ``[c | k_rope]`` directly, and its value half
  applied to the attention-weighted latent.  The prefix's latents are held
  once per image, the beams folded into the query rows against them
  (``fold``); the generated tokens' latents are per beam, in a cache the
  beam search reorders.

Parameter names follow the DeepSeek-V3 checkpoint's, except that the routed
experts are stacked for the grouped GEMM: ``mlp.w13`` [E, 2 I, D] is
``experts.{e}.gate_proj`` over ``experts.{e}.up_proj``, ``mlp.w2`` [E, D, I]
``experts.{e}.down_proj``; the router's ``mlp.gate.weight`` and
``mlp.gate.e_score_correction_bias`` keep theirs.

Spans (``utils.misc.trace_annotation``, while torch.profiler records):
``grit.mla`` around each attention, ``grit.moe`` around router, routed and
shared experts, ``grit.lm_head`` around the final norm, the head and the
log-softmax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from grit_tpu_torch.models.layers import Linear
from grit_tpu_torch.models.norm import LayerNorm
from grit_tpu_torch.ops import moe as moe_ops
from grit_tpu_torch.utils.misc import trace_annotation


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """-> in ``dtype`` (default: ``x``'s)."""
        return F.rms_norm(x.float(), (x.shape[-1],), self.weight, self.eps).to(dtype or x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """(cos, sin) f32 [..., dim] at ``positions`` (DeepSeek-V3's
    ``inv_freq``, repeated over both halves)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=positions.device,
                                       dtype=torch.float32) / dim)
    f = positions.float()[..., None] * inv
    emb = torch.cat([f, f], -1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotary form on the last dim of ``x`` (cos / sin
    broadcast against it), in f32, rounded back to ``x``'s type."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], -1)
    return (xf * cos + rot * sin).to(x.dtype)


def rope_matrix(cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The rotation of one position as an f32 [d, d] matrix R: ``x.float()
    @ R`` is ``apply_rope(x, cos, sin)`` (the rope is linear; R's rows are
    the rotated unit vectors), one product in place of its eight element-wise
    launches, for a decode step whose rows share their position."""
    return apply_rope(torch.eye(cos.shape[-1], device=cos.device), cos, sin)


class LatentAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.heads, self.rank = h, cfg.kv_lora_rank
        self.nope, self.rope, self.v_dim = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                                            cfg.v_head_dim)
        self.scale = (self.nope + self.rope) ** -0.5
        self.q_proj = Linear(d, h * (self.nope + self.rope), bias=False)
        self.kv_a_proj_with_mqa = Linear(d, self.rank + self.rope, bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, cfg.rms_norm_eps)
        self.kv_b_proj = Linear(self.rank, h * (self.nope + self.v_dim), bias=False)
        self.o_proj = Linear(h * self.v_dim, d, bias=False)

    def latent(self, x, cos, sin):
        """-> [..., kv_lora_rank + rope]: the normalised latent and the
        rotated shared key, as the cache keeps them."""
        kv = self.kv_a_proj_with_mqa(x)
        return torch.cat([self.kv_a_layernorm(kv[..., :self.rank]),
                          apply_rope(kv[..., self.rank:], cos, sin)], -1)

    def _query(self, x, cos, sin):
        q = self.q_proj(x).unflatten(-1, (self.heads, self.nope + self.rope))
        return q[..., :self.nope], apply_rope(q[..., self.nope:], cos[..., None, :],
                                              sin[..., None, :])

    def forward(self, x, cos, sin, mask):
        """Un-absorbed over whole sequences: x [B, S, D], cos / sin [S, rope],
        mask bool [B, 1, S, S] (True: masked) -> (out [B, S, D], latents [B,
        S, kv_lora_rank + rope])."""
        with trace_annotation("grit.mla"):
            b, s, _ = x.shape
            q_nope, q_rope = self._query(x, cos, sin)
            lat = self.latent(x, cos, sin)
            kv = self.kv_b_proj(lat[..., :self.rank]).unflatten(-1, (self.heads, -1))
            k_rope = lat[..., None, self.rank:].expand(-1, -1, self.heads, -1)
            q = torch.cat([q_nope, q_rope], -1).transpose(1, 2)
            k = torch.cat([kv[..., :self.nope], k_rope], -1).transpose(1, 2)
            scores = torch.matmul(q, k.transpose(-1, -2)).float() * self.scale
            p = torch.softmax(scores.masked_fill(mask, float("-inf")), -1).to(x.dtype)
            o = torch.matmul(p, kv[..., self.nope:].transpose(1, 2))
            return self.o_proj(o.transpose(1, 2).reshape(b, s, -1)), lat

    def decode(self, x, rot, prefix, prefix_mask, cache, slot: int, fold: int):
        """Absorbed, one token a row: x [R, D] with R = B * fold (the beams of
        an image adjacent), ``rot`` the step's ``rope_matrix``; ``prefix`` [B,
        P, kv_lora_rank + rope] per image with ``prefix_mask`` [B, P] (True:
        masked); ``cache`` [R, T, kv_lora_rank + rope] per beam, this token's
        latent written at ``slot`` and attended with the slots before it ->
        [R, D]."""
        with trace_annotation("grit.mla"):
            r, h, c = x.shape[0], self.heads, self.rank
            b = r // fold
            q = self.q_proj(x).unflatten(-1, (h, self.nope + self.rope))
            q_nope, q_rope = q[..., :self.nope], (q[..., self.nope:].float() @ rot).to(x.dtype)
            kv = self.kv_a_proj_with_mqa(x)
            cache[:, slot] = torch.cat([self.kv_a_layernorm(kv[..., :c]),
                                        (kv[..., c:].float() @ rot).to(x.dtype)], -1)
            w = self.kv_b_proj.weight.view(h, self.nope + self.v_dim, c)
            q = torch.cat([torch.einsum("rhn,hnc->rhc", q_nope, w[:, :self.nope]), q_rope], -1)
            own = cache[:, :slot + 1]
            s_pre = torch.bmm(q.reshape(b, fold * h, -1), prefix.transpose(1, 2)).float()
            s_pre = s_pre.masked_fill(prefix_mask[:, None, :], float("-inf"))
            s_own = torch.bmm(q, own.transpose(1, 2)).float()
            p = torch.softmax(torch.cat([s_pre.view(r, h, -1), s_own], -1) * self.scale,
                              -1).to(x.dtype)
            n_pre = prefix.shape[1]
            o = torch.bmm(p[..., :n_pre].reshape(b, fold * h, n_pre), prefix).view(r, h, -1)
            o = (o + torch.bmm(p[..., n_pre:], own))[..., :c]
            o = torch.einsum("rhc,hvc->rhv", o, w[:, self.nope:])
            return self.o_proj(o.reshape(r, -1))


class SwiGLU(nn.Module):
    """The dense FFN and the shared experts: down(silu(gate x) * up x)."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = Linear(d, width, bias=False)
        self.up_proj = Linear(d, width, bias=False)
        self.down_proj = Linear(width, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    """sigmoid scores in f32; the top k of scores + correction bias; the
    chosen scores normalised and scaled."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.scoring_func != "sigmoid" or cfg.topk_method != "noaux_tc":
            raise NotImplementedError("the router takes scoring_func='sigmoid' with "
                                      "topk_method='noaux_tc'")
        if cfg.n_group != cfg.topk_group:
            raise NotImplementedError("the router keeps every expert group "
                                      "(n_group == topk_group)")
        self.top_k, self.norm = cfg.num_experts_per_tok, bool(cfg.norm_topk_prob)
        self.scaling = float(cfg.routed_scaling_factor)
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(cfg.n_routed_experts))

    def forward(self, x):
        """x [n, D] -> (expert ids [n, k] long, weights [n, k] f32)."""
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        idx = torch.topk(scores + self.e_score_correction_bias.float(), self.top_k, dim=-1).indices
        w = scores.gather(1, idx)
        if self.norm:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * self.scaling


class MoE(nn.Module):
    #: ``captioner.to_compute_dtype`` rounds this module's own parameters
    #: (the stacked experts) as it rounds a Linear's
    stacked_linear = True

    def __init__(self, cfg):
        super().__init__()
        d, i, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.n_routed_experts
        self.gate = Router(cfg)
        self.w13 = nn.Parameter(torch.empty(e, 2 * i, d))
        self.w2 = nn.Parameter(torch.empty(e, d, i))
        self.shared_experts = SwiGLU(d, i * cfg.n_shared_experts)

    def forward(self, x):
        """-> f32, the residual stream's type."""
        with trace_annotation("grit.moe"):
            flat = x.reshape(-1, x.shape[-1])
            idx, w = self.gate(flat)
            y = moe_ops.routed_experts(flat, idx, w, self.w13, self.w2)
            return (y + self.shared_experts(flat).float()).view(x.shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, dense: bool):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(d, eps)
        self.self_attn = LatentAttention(cfg)
        self.post_attention_layernorm = RMSNorm(d, eps)
        self.mlp = SwiGLU(d, cfg.intermediate_size) if dense else MoE(cfg)

    def forward(self, x, cos, sin, mask):
        """x: the f32 residual stream; each branch reads it normalised in
        the compute type and adds its output back in f32."""
        dt = self.self_attn.o_proj.weight.dtype
        a, lat = self.self_attn(self.input_layernorm(x, dt), cos, sin, mask)
        x = x + a.float()
        return x + self.mlp(self.post_attention_layernorm(x, dt)).float(), lat

    def decode(self, x, rot, prefix, prefix_mask, cache, slot, fold):
        dt = self.self_attn.o_proj.weight.dtype
        x = x + self.self_attn.decode(self.input_layernorm(x, dt), rot, prefix, prefix_mask,
                                      cache, slot, fold).float()
        return x + self.mlp(self.post_attention_layernorm(x, dt)).float()


class LanguageModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        if cfg.q_lora_rank is not None or cfg.rope_scaling is not None:
            raise NotImplementedError("the MLA path takes q_lora_rank null and no rope scaling")
        if cfg.attention_bias or cfg.tie_word_embeddings:
            raise NotImplementedError("attention biases and tied embeddings are not built")
        self.cfg = cfg
        #: set by ``captioner.to_compute_dtype``; None = the dtype of the weights
        self.compute_dtype = None
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        first, freq = cfg.first_k_dense_replace, cfg.moe_layer_freq
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dense=i < first or (i - first) % freq != 0)
            for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def _dtype(self) -> torch.dtype:
        return self.compute_dtype or self.lm_head.weight.dtype

    def rope(self, positions: torch.Tensor):
        return rope_tables(positions, self.cfg.qk_rope_head_dim, float(self.cfg.rope_theta))

    def forward(self, x, key_mask):
        """x [B, S, D] (slot i at position i), key_mask bool [B, S] (True:
        never attended) -> (hidden [B, S, D] f32, each layer's latents [B, S,
        kv_lora_rank + rope] in the compute type)."""
        x = x.float()
        s = x.shape[1]
        cos, sin = self.rope(torch.arange(s, device=x.device))
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).triu(1)
        mask = causal[None, None] | key_mask[:, None, None, :]
        latents = []
        for layer in self.layers:
            x, lat = layer(x, cos, sin, mask)
            latents.append(lat)
        return x, latents

    def log_probs(self, x) -> torch.Tensor:
        """Final norm, head (in the compute type) and log-softmax (f32)."""
        with trace_annotation("grit.lm_head"):
            return torch.log_softmax(self.lm_head(self.norm(x, self._dtype())).float(), -1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """DeepSeek-V3's start: every matrix normal with std
        ``initializer_range`` (0.02), norm scales 1, correction bias 0."""
        std = float(self.cfg.get("initializer_range", 0.02))
        for name, p in self.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, std, generator=generator)
            elif name.endswith("e_score_correction_bias"):
                p.zero_()
            else:
                p.fill_(1.0)


class _Projector(nn.Module):
    """LayerNorm, Linear, exact (erf) GELU, Linear."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.pre_norm = LayerNorm(d_in, eps=1e-5)
        self.linear_1 = Linear(d_in, d_in)
        self.linear_2 = Linear(d_in, d_out)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(self.pre_norm(x))))


class VisualProjector(nn.Module):
    """GRIT's region and grid features into the language model's width, one
    MLP for each kind (Kimi-VL's projector form: LayerNorm, Linear, GELU,
    Linear)."""

    def __init__(self, d_vis: int, hidden: int):
        super().__init__()
        self.region = _Projector(d_vis, hidden)
        self.grid = _Projector(d_vis, hidden)

    def forward(self, vis: dict):
        """-> (tokens [B, R + G, hidden]: the regions then the grid slots,
        key mask [B, R + G] bool: True at a padded grid slot)."""
        b = vis["reg_feat"].shape[0]
        tokens = torch.cat([self.region(vis["reg_feat"]), self.grid(vis["gri_feat"])], 1)
        mask = torch.cat([vis["reg_mask"].reshape(b, -1), vis["gri_mask"].reshape(b, -1)], 1)
        return tokens, mask

