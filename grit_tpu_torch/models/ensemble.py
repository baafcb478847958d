"""Ensemble caption inference: average per-step log-probs over N members.

Capability parity with the reference's ensemble (models/caption/ensemble.py,
the mean of the members' log-probs at each beam step, :159) and with
grit_tpu/models/ensemble.py: every member keeps its own KV caches and visual
inputs inside one shared beam search, so the ensemble decodes once per step.
Each member also keeps its own projected visual K/V (``precompute_vis_kv``),
so with the parallel decoder every member's layers take the fused decode
tail (K11) as a single model's do.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from grit_tpu_torch.decoding.beam_search import BeamResult, beam_search


def make_ensemble_generator(models: Sequence, *, beam_size: int, max_len: int, bos_idx: int,
                            eos_idx: int, out_size: int = 1) -> Callable:
    """-> generate(samples on the members' device, batch_size) -> BeamResult,
    the members' log-probs averaged in f32 at each step.  The members run in
    the mode they are in: put them in ``eval()`` first."""

    @torch.inference_mode()
    def generate(samples, batch_size: int) -> BeamResult:
        members = []
        for model in models:
            vis = model.compute_vis(samples)
            members.append({"feat": vis, "kv": model.precompute_vis_kv(vis)})

        def decode_fn(token, t, vis_list, caches):
            logps, new_caches = [], []
            for model, vis_in, cache in zip(models, vis_list, caches):
                lp, cache = model.decode_step(token, t, vis_in["feat"], cache,
                                              vis_kv=vis_in["kv"], vis_fold=beam_size)
                logps.append(lp.float())
                new_caches.append(cache)
            return torch.stack(logps).mean(0), new_caches

        caches = [model.init_cache(batch_size * beam_size, max_len) for model in models]
        return beam_search(decode_fn, caches, members, batch_size, beam_size, max_len,
                           bos_idx, eos_idx, out_size=out_size)

    return generate
