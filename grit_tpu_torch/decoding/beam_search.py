"""Batched beam search with fixed-shape caches.

Decision parity with the reference beam search (models/caption/transformer.py
:75-254) and with grit_tpu.decoding.beam_search:

- step 0 expands from beam 0 alone (``seq_logprob`` 0 for beam 0, -inf for
  the rest), the reference's ``cur_beam_size=1`` special case (:205);
- EOS freeze (:211-220): a beam that chose EOS gets zeroed word log-probs
  and the candidate row ``[seq_logprob, -999, ...]``, so it persists and
  appends token 0;
- selection is the top ``beam`` of the flattened ``beam x V`` candidates,
  lower flat index first on ties (``jax.lax.top_k``): a stable descending
  sort, then a slice;
- caches are reordered by the selected parent beam each step; token
  sequences come back by parent-pointer backtracking;
- final beams sorted by total log-prob (stable), truncated to ``out_size``.

Early exit: the loop stops once every beam of every image is frozen, which
is decision-identical (grit_tpu/decoding/beam_search.py:41-51).  Deciding it
reads one flag back from the device each step.  ``return_all_probs`` runs all
``max_len`` steps instead: a frozen step's word log-probs are live model
output, which a skipped step could not record.

``greedy_search`` is beam 1.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from grit_tpu_torch.utils.misc import trace_annotation

NEG_INF = float("-inf")


class BeamResult(NamedTuple):
    sequences: torch.Tensor   # long [B, out_size, max_len]
    log_probs: torch.Tensor   # float [B, out_size, max_len] per-step word log-probs
    scores: torch.Tensor      # float [B, out_size] total sequence log-prob
    # float [B, out_size, max_len, V], when requested: at each step, the word
    # log-probs that the beam in each slot was chosen from (the slots as that
    # step left them, not backtracked, as grit_tpu records them), the slots
    # put in the final beam order
    all_log_probs: Optional[torch.Tensor] = None
    # float [B, max_len]: per step, the smallest gap between adjacent
    # candidates among the top beam+1 (the step's decision margin; inf for
    # skipped steps), when requested
    margins: Optional[torch.Tensor] = None


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def beam_search(decode_step: Callable, init_cache, vis_inputs, batch_size: int,
                beam_size: int, max_len: int, bos_idx: int, eos_idx: int,
                out_size: int = 1, return_all_probs: bool = False,
                return_margins: bool = False) -> BeamResult:
    """decode_step(token [B*K, 1], t, vis, cache) -> (log_probs [B*K, V], cache).

    ``init_cache`` is beam-expanded [B*K, ...]; ``vis_inputs`` go to
    decode_step per image ([B, ...]), which folds the beams itself
    (``vis_fold``), as grit_tpu's ``tile_vis=False``.
    """
    with trace_annotation("grit.beam_search"):
        b, k = batch_size, beam_size
        dev = next(_leaves(init_cache)).device
        seq_logprob = torch.full((b, k), NEG_INF, device=dev)
        seq_logprob[:, 0] = 0.0
        seq_mask = torch.ones((b, k), device=dev)
        prev_words = torch.full((b, k), bos_idx, dtype=torch.long, device=dev)
        cache = init_cache
        base = (torch.arange(b, device=dev) * k)[:, None]
        words, parents, wlogp, margins, all_logp = [], [], [], [], []

        for t in range(max_len):
            alive = (seq_mask > 0) & (prev_words != eos_idx)
            if not return_all_probs and not bool((alive | (seq_logprob <= -999.0)).any()):
                break   # all beams frozen: the remaining steps change nothing
            word_logprob, cache = decode_step(prev_words.reshape(b * k, 1), t, vis_inputs, cache)
            v = word_logprob.shape[-1]
            word_logprob = word_logprob.reshape(b, k, v)
            if t > 0:
                seq_mask = seq_mask * (prev_words != eos_idx).float()
            word_logprob_m = word_logprob * seq_mask[..., None]
            candidate = seq_logprob[..., None] + word_logprob_m
            frozen = torch.full_like(candidate, -999.0)
            frozen[..., 0] = seq_logprob
            candidate = torch.where(seq_mask[..., None] > 0, candidate, frozen)

            with trace_annotation("grit.beam_sort"):
                vals, idx = torch.sort(candidate.reshape(b, k * v), dim=1, descending=True,
                                       stable=True)
                sel_beam, sel_words = idx[:, :k] // v, idx[:, :k] % v
            if return_margins:
                margins.append((vals[:, :k] - vals[:, 1:k + 1]).min(1).values)
            flat = (base + sel_beam).reshape(-1)
            with trace_annotation("grit.cache_reorder"):
                cache = _map_tree(lambda x: x.index_select(0, flat), cache)
            seq_mask = torch.gather(seq_mask, 1, sel_beam)
            this_wlogp = torch.gather(word_logprob_m.reshape(b, k * v), 1, idx[:, :k])
            seq_logprob = vals[:, :k]
            prev_words = sel_words
            words.append(sel_words)
            parents.append(sel_beam)
            wlogp.append(this_wlogp)
            if return_all_probs:
                all_logp.append(torch.gather(word_logprob, 1,
                                             sel_beam[..., None].expand(-1, -1, v)))

        # steps skipped by the early exit record word 0, log-prob 0, identity parents
        ident = torch.arange(k, device=dev)[None].expand(b, k)
        for _ in range(max_len - len(words)):
            words.append(torch.zeros((b, k), dtype=torch.long, device=dev))
            parents.append(ident)
            wlogp.append(torch.zeros((b, k), device=dev))
            if return_margins:
                margins.append(torch.full((b,), float("inf"), device=dev))

        beam_idx = ident
        seq_rev, lp_rev = [], []
        for t in reversed(range(max_len)):
            seq_rev.append(torch.gather(words[t], 1, beam_idx))
            lp_rev.append(torch.gather(wlogp[t], 1, beam_idx))
            beam_idx = torch.gather(parents[t], 1, beam_idx)
        sequences = torch.stack(seq_rev[::-1], 2)   # [B, K, T]
        log_probs = torch.stack(lp_rev[::-1], 2)

        order = torch.sort(-seq_logprob, dim=1, stable=True).indices
        scores = torch.gather(seq_logprob, 1, order)[:, :out_size]
        sel = order[..., None].expand(-1, -1, max_len)
        sequences = torch.gather(sequences, 1, sel)[:, :out_size]
        log_probs = torch.gather(log_probs, 1, sel)[:, :out_size]
        all_log_probs = None
        if return_all_probs:
            alp = torch.stack(all_logp, 2)                            # [B, K, T, V]
            all_log_probs = torch.gather(
                alp, 1, order[..., None, None].expand(-1, -1, *alp.shape[2:]))[:, :out_size]
        return BeamResult(sequences, log_probs, scores, all_log_probs,
                          torch.stack(margins, 1) if return_margins else None)


def greedy_search(decode_step: Callable, init_cache, vis_inputs, batch_size: int,
                  max_len: int, bos_idx: int, eos_idx: int):
    """Greedy decode = beam 1; returns (sequences [B, T], log_probs [B, T])."""
    res = beam_search(decode_step, init_cache, vis_inputs, batch_size, 1, max_len,
                      bos_idx, eos_idx, out_size=1)
    return res.sequences[:, 0], res.log_probs[:, 0]
