"""Plain float32 reference of Kimi-VL-A3B-Instruct's language model as
GRIT's caption decoder: the projector of GRIT's region and grid features,
the full causal forward over the visual prefix and the words with no cache,
the router and each expert written out, the log-probs by teacher forcing,
and a beam search that runs that forward from scratch at every step.

It follows DeepSeek-V3's public modelling code (``modeling_deepseek.py``),
which Kimi-VL's language model uses: RMSNorm; RoPE on the rope channels of
q and of the one shared key, the channel pairs (2i, 2i+1) de-interleaved to
(i, d/2 + i) then rotated by halves; MLA with ``q_lora_rank`` null (q from
one projection; the latent normalised, then K and V expanded from it by
``kv_b_proj``; scale 1 / sqrt(nope + rope)); the ``noaux_tc`` sigmoid router
over one group (the correction bias only chooses, the chosen scores are
normalised and scaled); SwiGLU experts, the shared ones as one SwiGLU.
Departures:

- the visual tokens are GRIT's (``gritbench/reference/vision.py``) through
  one MLP per kind (LayerNorm, Linear, exact GELU, Linear), not MoonViT's;
- the routed experts are read stacked (``mlp.w13`` [E, 2 I, D]: each
  expert's gate rows over its up rows; ``mlp.w2`` [E, D, I]), as the port
  names them; each expert is still applied alone, to the rows routed to it;
- the prefix is causal too, and a padded grid slot is masked as a key;
- ``forward`` takes the prefix once per image and ``fold`` rows of words
  per image (a beam search's beams): each row attends to its image's
  prefix.  Nothing is carried from one call to the next;
- ties: given the program's expert choices, a row whose choices differ
  from this router's only among experts that score within ``tie`` of its
  k-th best takes the program's (``route``).  Top-6 of 64 sigmoid scores
  has near-ties in every layer; a bf16 rounding upstream flips some, each
  flip moves a row by a whole expert's output, and 26 such layers compound
  the flips of the layers before.  Rounding moves a choice no further than
  the tie; a wrong router or a wrong number of experts is not a tie.  The
  share of rows whose choices differ at all (``stats``) is a number the
  benchmark checks too: a router that drops the correction bias moves
  choices by less than the bias, some within the tie, but in most rows.

Every product goes through ``Arith`` (float32 with TF32 off under
``fp32_context``); the router's scores, the norms and the softmaxes are
float32.  ``P`` maps parameter names to tensors; it may draw them on demand
(the benchmark hands in a mapping that holds one layer at a time): each
layer's parameters are read inside that layer's step only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gritbench.reference.nn import Arith

LM = "language_model"


def rms_norm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, pos, theta: float):
    """DeepSeek-V3's rotary embedding of ``x`` [..., S, (heads,) d] at
    positions ``pos`` [S] (``heads``: pass ``pos`` shaped [S, 1])."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos.float()[..., None] * inv
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    x = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def projector(A: Arith, P, name: str, x):
    x = F.layer_norm(x.float(), (x.shape[-1],), P[name + ".pre_norm.weight"],
                     P[name + ".pre_norm.bias"], 1e-5)
    x = F.gelu(A.linear(x, P[name + ".linear_1.weight"], P[name + ".linear_1.bias"]))
    return A.linear(x, P[name + ".linear_2.weight"], P[name + ".linear_2.bias"])


def project(A: Arith, P, vis: dict):
    """GRIT's features -> (prefix tokens [N, R + G, D]: regions then grid
    slots, key mask [N, R + G]: True at a padded grid slot)."""
    reg = projector(A, P, "projector.region", vis["reg_feat"])
    gri = projector(A, P, "projector.grid", vis["gri_feat"])
    n = reg.shape[0]
    mask = torch.cat([torch.zeros(reg.shape[:2], dtype=torch.bool, device=reg.device),
                      vis["gri_mask"].reshape(n, -1)], 1)
    return torch.cat([reg, gri], 1), mask


def mla_parts(A: Arith, P, name: str, h, pos, cfg: dict):
    """-> q [N, S, H, nope + rope], k alike, v [N, S, H, v], and the latent
    [N, S, rank + rope] (the normalised latent and the rotated key)."""
    heads, nope, rd = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    rank, theta = cfg["kv_lora_rank"], float(cfg["rope_theta"])
    q = A.linear(h, P[name + ".q_proj.weight"]).unflatten(-1, (heads, nope + rd))
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos[:, None], theta)], -1)
    kv_a = A.linear(h, P[name + ".kv_a_proj_with_mqa.weight"])
    c = rms_norm(kv_a[..., :rank], P[name + ".kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    k_rope = rope(kv_a[..., rank:], pos, theta)
    kv = A.linear(c, P[name + ".kv_b_proj.weight"]).unflatten(-1, (heads, -1))
    k = torch.cat([kv[..., :nope], k_rope[..., None, :].expand(*kv.shape[:-1], rd)], -1)
    return q, k, kv[..., nope:], torch.cat([c, k_rope], -1)


def attend(A: Arith, q, k, v, mask, scale: float):
    """q [N, Sq, H, d], k [N, Sk, H, d], v [N, Sk, H, dv], mask bool
    broadcast to [N, 1, Sq, Sk] (True: masked) -> [N, Sq, H * dv]."""
    s = A.matmul(q.transpose(1, 2), k.transpose(1, 2).transpose(-1, -2)) * scale
    p = torch.softmax(s.masked_fill(mask, float("-inf")), -1)
    o = A.matmul(p, v.transpose(1, 2))
    return o.transpose(1, 2).flatten(2)


def swiglu(A: Arith, x, gate, up, down):
    return A.linear(F.silu(A.linear(x, gate)) * A.linear(x, up), down)


def route(P, name: str, x, cfg: dict, hint=None, tie: float = 0.0, stats=None):
    """The router in float32 -> (expert ids [n, k], weights [n, k]).

    ``hint`` [n, k']: another computation's choices of the same rows (the
    program's; a row of -1: none).  A row takes its hint where it is a
    top-k under a tie: k' == k and each hinted expert's choice score lies
    within ``tie`` of this router's k-th best; elsewhere it keeps its own
    choice.  The weights are always this router's scores of the experts
    taken.  ``stats`` (a dict) counts the hinted rows, those whose hint is
    another set of experts (every row, where k' != k), those that took such
    a hint, and the widest tie taken."""
    scores = torch.sigmoid(x.float() @ P[name + ".gate.weight"].float().t())
    choice = scores + P[name + ".gate.e_score_correction_bias"].float()
    k = cfg["num_experts_per_tok"]
    idx = torch.topk(choice, k, dim=-1).indices
    if hint is not None and hint.shape[1] == k:
        hinted = (hint >= 0).all(1, keepdim=True)
        kth = choice.gather(1, idx).min(1, keepdim=True).values
        below = kth - choice.gather(1, hint.clamp_min(0))
        tied = (below <= tie).all(1, keepdim=True) & hinted
        differ = (hint.sort(1).values != idx.sort(1).values).any(1, keepdim=True) & hinted
        if stats is not None:
            stats["rows"] = stats.get("rows", 0) + int(hinted.sum())
            stats["differ"] = stats.get("differ", 0) + int(differ.sum())
            stats["taken"] = stats.get("taken", 0) + int((differ & tied).sum())
            used = below.amax(1, keepdim=True)[differ & tied]
            widest = float(used.max()) if used.numel() else 0.0
            stats["widest"] = max(stats.get("widest", 0.0), widest)
        idx = torch.where(tied, hint, idx)
    elif hint is not None and stats is not None:
        hinted = int((hint >= 0).all(1).sum())
        stats["rows"] = stats.get("rows", 0) + hinted
        stats["differ"] = stats.get("differ", 0) + hinted
    w = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def moe(A: Arith, P, name: str, x, cfg: dict, hint=None, tie: float = 0.0, stats=None):
    """x [n, D]: each routed expert on its rows, weighted, plus the shared
    experts (``hint``, ``tie``, ``stats``: ``route``'s)."""
    idx, w = route(P, name, x, cfg, hint, tie, stats)
    w13, w2 = P[name + ".w13"], P[name + ".w2"]
    width = cfg["moe_intermediate_size"]
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        hit = idx == e
        rows = hit.any(1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        we = (w * hit).sum(1)[rows]
        out[rows] += we[:, None] * swiglu(A, x[rows], w13[e, :width], w13[e, width:], w2[e])
    s = name + ".shared_experts"
    return out + swiglu(A, x, P[s + ".gate_proj.weight"], P[s + ".up_proj.weight"],
                        P[s + ".down_proj.weight"])


def dense_mlp(A: Arith, P, name: str, x):
    return swiglu(A, x, P[name + ".gate_proj.weight"], P[name + ".up_proj.weight"],
                  P[name + ".down_proj.weight"])


def is_moe(i: int, cfg: dict) -> bool:
    first = cfg["first_k_dense_replace"]
    return i >= first and (i - first) % cfg["moe_layer_freq"] == 0


def forward(A: Arith, P, prefix, prefix_mask, ids, cfg: dict, fold: int = 1, routes=None,
            tie: float = 0.0, stats=None) -> dict:
    """The full causal forward over [prefix | words]: prefix [N, Pn, D]
    (slot i at position i), prefix_mask [N, Pn], ids [N * fold, L] (BOS
    first; row n * fold + j reads image n's prefix) -> {"hidden": the words'
    last hidden states [N * fold, L, D] (before the final norm), "latent":
    the last layer's prefix latents [N, Pn, rank + rope]}.  ``routes``: for
    each MoE layer, a hint [N Pn + N fold L, k'] of the program's choices
    for the prefix rows then the word rows (``route``)."""
    n, pn, _ = prefix.shape
    length = ids.shape[1]
    dev = prefix.device
    eps = cfg["rms_norm_eps"]
    scale = 1.0 / math.sqrt(cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"])
    xp = prefix.float()
    xt = P[LM + ".embed_tokens.weight"][ids].float()
    pos_p = torch.arange(pn, device=dev)
    pos_t = torch.arange(pn, pn + length, device=dev)
    causal_p = torch.ones(pn, pn, dtype=torch.bool, device=dev).triu(1)
    mask_p = causal_p[None, None] | prefix_mask[:, None, None, :]
    causal_t = torch.ones(length, length, dtype=torch.bool, device=dev).triu(1)
    mask_t = torch.cat([prefix_mask.repeat_interleave(fold, 0)[:, None, None, :]
                        .expand(-1, 1, length, pn),
                        causal_t[None, None].expand(n * fold, 1, -1, -1)], -1)
    latent, hints = None, iter(routes or ())
    for i in range(cfg["num_hidden_layers"]):
        name = f"{LM}.layers.{i}"
        a = name + ".self_attn"
        hp = rms_norm(xp, P[name + ".input_layernorm.weight"], eps)
        ht = rms_norm(xt, P[name + ".input_layernorm.weight"], eps)
        qp, kp, vp, latent = mla_parts(A, P, a, hp, pos_p, cfg)
        qt, kt, vt, _ = mla_parts(A, P, a, ht, pos_t, cfg)
        op = attend(A, qp, kp, vp, mask_p, scale)
        ot = attend(A, qt, torch.cat([kp.repeat_interleave(fold, 0), kt], 1),
                    torch.cat([vp.repeat_interleave(fold, 0), vt], 1), mask_t, scale)
        xp = xp + A.linear(op, P[a + ".o_proj.weight"])
        xt = xt + A.linear(ot, P[a + ".o_proj.weight"])
        rows = torch.cat([xp.reshape(-1, xp.shape[-1]), xt.reshape(-1, xt.shape[-1])])
        h = rms_norm(rows, P[name + ".post_attention_layernorm.weight"], eps)
        if is_moe(i, cfg):
            y = moe(A, P, name + ".mlp", h, cfg, next(hints, None), tie, stats)
        else:
            y = dense_mlp(A, P, name + ".mlp", h)
        rows = rows + y
        xp = rows[:n * pn].view(xp.shape)
        xt = rows[n * pn:].view(xt.shape)
    return {"hidden": xt, "latent": latent}


def log_probs(A: Arith, P, h, cfg: dict):
    """Final norm, head, log-softmax."""
    h = rms_norm(h, P[LM + ".norm.weight"], cfg["rms_norm_eps"])
    return torch.log_softmax(A.linear(h, P[LM + ".lm_head.weight"]), -1)


def served_log_probs(A: Arith, P, tokens, prefix, prefix_mask, cfg: dict, bos: int,
                     routes=None, tie: float = 0.0, stats=None) -> dict:
    """By teacher forcing: {"served" [N, T]: the log-prob of each served
    token given the tokens before it, "latent": the last layer's prefix
    latents}."""
    ids = torch.cat([torch.full_like(tokens[:, :1], bos), tokens[:, :-1]], 1)
    out = forward(A, P, prefix, prefix_mask, ids, cfg, routes=routes, tie=tie, stats=stats)
    lp = log_probs(A, P, out["hidden"], cfg)
    return {"served": torch.gather(lp, 2, tokens[..., None])[..., 0], "latent": out["latent"]}


def beam_search(A: Arith, P, prefix, prefix_mask, cfg: dict, *, beam: int, steps: int,
                bos: int, eos: int) -> dict:
    """The released decision rules (as ``reference/caption.py``'s: step 0
    expands beam 0, an ended beam is frozen at its score and appends token
    0, the top ``beam`` of all candidates, lower flat index first on ties),
    each step scored by a whole forward of [prefix | BOS, words] -> the
    best beam's {"tokens" [N, T], "log_probs" [N, T], "score" [N]}."""
    n, dev = prefix.shape[0], prefix.device
    score = torch.full((n, beam), float("-inf"), device=dev)
    score[:, 0] = 0.0
    live = torch.ones((n, beam), device=dev)
    prev = torch.full((n, beam), bos, dtype=torch.long, device=dev)
    hist = torch.zeros((n, beam, 0), dtype=torch.long, device=dev)
    lps = torch.zeros((n, beam, 0), device=dev)
    for t in range(steps):
        ended = ~((live > 0) & (prev != eos))
        if bool((ended & (score > -999.0)).all()):
            break
        ids = torch.cat([torch.full((n * beam, 1), bos, dtype=torch.long, device=dev),
                         hist.reshape(n * beam, t)], 1)
        h = forward(A, P, prefix, prefix_mask, ids, cfg, fold=beam)["hidden"][:, -1]
        word = log_probs(A, P, h, cfg).reshape(n, beam, -1)
        v = word.shape[-1]
        if t > 0:
            live = live * (prev != eos).float()
        word = word * live[..., None]
        cand = score[..., None] + word
        frozen = torch.full_like(cand, -999.0)
        frozen[..., 0] = score
        cand = torch.where(live[..., None] > 0, cand, frozen)
        vals, idx = torch.sort(cand.reshape(n, beam * v), dim=1, descending=True, stable=True)
        parent, w = idx[:, :beam] // v, idx[:, :beam] % v
        live = torch.gather(live, 1, parent)
        lp = torch.gather(word.reshape(n, beam * v), 1, idx[:, :beam])
        hist = torch.cat([torch.gather(hist, 1, parent[..., None].expand(-1, -1, t)),
                          w[..., None]], 2)
        lps = torch.cat([torch.gather(lps, 1, parent[..., None].expand(-1, -1, t)),
                         lp[..., None]], 2)
        score, prev = vals[:, :beam], w
    pad = steps - hist.shape[2]
    hist = F.pad(hist, (0, pad))
    lps = F.pad(lps, (0, pad))
    best = torch.sort(-score, dim=1, stable=True).indices[:, 0]
    rows = torch.arange(n, device=dev)
    return {"tokens": hist[rows, best], "log_probs": lps[rows, best], "score": score[rows, best]}
