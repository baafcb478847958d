"""Plain float32 reference of GRIT's caption generator (the "parallel"
decoder: self-attention, then a grid and a region cross-attention fused by
sigmoid gates, then the feed-forward block, all post-LN) and of its beam
search.

The released model computes both gates with ``fc_alpha1``
(davidnvq/grit ``models/caption/cap_generator.py:48-49``); the configuration
states whether that is kept (``replicate_alpha_bug``).  Beam search follows
the released decision rules (``models/caption/transformer.py:75-254``):
step 0 expands beam 0 alone, a beam that chose EOS is frozen at its score
and appends token 0, the top ``beam`` of all ``beam x V`` candidates are
kept with the lower flat index first on ties, and the loop stops early once
every beam has ended.  Each step scores its prefixes by teacher forcing,
without a cache.
"""

from __future__ import annotations

import math

import torch

from gritbench.reference.nn import Arith, dense, ffn, identity, mha


def decoder_log_probs(A: Arith, P, ids: torch.Tensor, vis: dict, cfg: dict,
                      drop=identity) -> torch.Tensor:
    """Teacher forcing: int [N, L] -> log-probs [N, L, V] of the next word at
    each position.  ``vis`` holds gri_feat, gri_mask, reg_feat per row;
    ``drop``: a training step's dropout."""
    n, L = ids.shape
    g = "cap_generator"
    is_pad = ids == cfg["pad_idx"]
    keep = (~is_pad)[..., None].float()
    causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).triu(1)
    mask_x = causal[None, None] | is_pad[:, None, None, :]
    seq = torch.arange(1, L + 1, device=ids.device)[None] * (~is_pad)
    x = P[g + ".word_emb.weight"][ids] + P[g + ".pos_emb.weight"][seq]
    y1, y2 = vis["gri_feat"].float(), vis["reg_feat"].float()
    m1 = vis["gri_mask"]
    m2 = torch.zeros((n, 1, 1, y2.shape[1]), dtype=torch.bool, device=ids.device)
    h = cfg["n_heads"]
    for i in range(cfg["decoder_layers"]):
        ln = f"{g}.layers.{i}"
        sa = mha(A, P, ln + ".self_att", x, x, x, h, mask_x, drop) * keep
        e1 = mha(A, P, ln + ".vis_att1", sa, y1, y1, h, m1, drop) * keep
        e2 = mha(A, P, ln + ".vis_att2", sa, y2, y2, h, m2, drop) * keep
        gate2 = ln + (".fc_alpha1" if cfg["replicate_alpha_bug"] else ".fc_alpha2")
        a1 = torch.sigmoid(dense(A, torch.cat([sa, e1], -1), P, ln + ".fc_alpha1"))
        a2 = torch.sigmoid(dense(A, torch.cat([sa, e2], -1), P, gate2))
        enc = (e1 * a1 + e2 * a2) / math.sqrt(2) * keep
        x = ffn(A, P, ln + ".pwff", enc, drop) * keep
    logits = A.linear(x, P[g + ".fc.weight"])
    return torch.log_softmax(logits, -1)


def expand(vis: dict, k: int) -> dict:
    return {name: t.repeat_interleave(k, 0) for name, t in vis.items()}


def served_log_probs(A: Arith, P, tokens: torch.Tensor, vis: dict, cfg: dict) -> torch.Tensor:
    """The log-prob [N, T] of each served token given the served tokens before
    it (step t reads [BOS, w_0 .. w_{t-1}])."""
    bos = torch.full_like(tokens[:, :1], cfg["bos_idx"])
    ids = torch.cat([bos, tokens[:, :-1]], 1)
    lp = decoder_log_probs(A, P, ids, vis, cfg)
    return torch.gather(lp, 2, tokens[..., None])[..., 0]


def beam_search(A: Arith, P, vis: dict, cfg: dict) -> dict:
    """-> {"tokens" [B, T], "log_probs" [B, T] (the word log-probs along the
    best beam, 0 after its EOS), "score" [B]} of the best beam."""
    b = vis["gri_feat"].shape[0]
    k, steps, eos = cfg["beam_size"], cfg["beam_len"], cfg["eos_idx"]
    dev = vis["gri_feat"].device
    vis_k = expand(vis, k)
    score = torch.full((b, k), float("-inf"), device=dev)
    score[:, 0] = 0.0
    live = torch.ones((b, k), device=dev)
    prev = torch.full((b, k), cfg["bos_idx"], dtype=torch.long, device=dev)
    hist = torch.zeros((b, k, 0), dtype=torch.long, device=dev)
    lps = torch.zeros((b, k, 0), device=dev)
    for t in range(steps):
        ended = ~((live > 0) & (prev != eos))
        if bool((ended & (score > -999.0)).all()):
            break
        ids = torch.cat([torch.full((b * k, 1), cfg["bos_idx"], dtype=torch.long, device=dev),
                         hist.reshape(b * k, t)], 1)
        word = decoder_log_probs(A, P, ids, vis_k, cfg)[:, -1].reshape(b, k, -1)
        v = word.shape[-1]
        if t > 0:
            live = live * (prev != eos).float()
        word = word * live[..., None]
        cand = score[..., None] + word
        frozen = torch.full_like(cand, -999.0)
        frozen[..., 0] = score
        cand = torch.where(live[..., None] > 0, cand, frozen)
        vals, idx = torch.sort(cand.reshape(b, k * v), dim=1, descending=True, stable=True)
        parent, w = idx[:, :k] // v, idx[:, :k] % v
        live = torch.gather(live, 1, parent)
        lp = torch.gather(word.reshape(b, k * v), 1, idx[:, :k])
        hist = torch.cat([torch.gather(hist, 1, parent[..., None].expand(-1, -1, t)),
                          w[..., None]], 2)
        lps = torch.cat([torch.gather(lps, 1, parent[..., None].expand(-1, -1, t)),
                         lp[..., None]], 2)
        score, prev = vals[:, :k], w
    pad = steps - hist.shape[2]
    hist = torch.nn.functional.pad(hist, (0, pad))
    lps = torch.nn.functional.pad(lps, (0, pad))
    best = torch.sort(-score, dim=1, stable=True).indices[:, 0]
    rows = torch.arange(b, device=dev)
    return {"tokens": hist[rows, best], "log_probs": lps[rows, best], "score": score[rows, best]}
