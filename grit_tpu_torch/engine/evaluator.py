"""Caption generation for evaluation (reference engine/caption_engine.py:144-230)."""

from __future__ import annotations

from typing import Callable

import torch

from grit_tpu_torch.decoding.beam_search import beam_search


def make_caption_generator(model, *, beam_size: int, max_len: int, bos_idx: int,
                           eos_idx: int) -> Callable:
    """-> generate(samples: ImageBatch on the model's device, batch_size)
    returning the top beam's tokens [B, max_len]."""

    @torch.inference_mode()
    def generate(samples, batch_size: int) -> torch.Tensor:
        vis = model.compute_vis(samples)
        # the step-invariant visual K/V are projected once per batch
        kv = model.precompute_vis_kv(vis)

        def decode_fn(token, t, vis_in, cache):
            # vis stays per image: the cross attentions fold the beams into
            # the query rows instead of tiling the K/V
            return model.decode_step(token, t, vis_in["feat"], cache,
                                     vis_kv=vis_in["kv"], vis_fold=beam_size)

        cache = model.init_cache(batch_size * beam_size, max_len)
        res = beam_search(decode_fn, cache, {"feat": vis, "kv": kv}, batch_size, beam_size,
                          max_len, bos_idx, eos_idx, out_size=1)
        return res.sequences[:, 0]

    return generate
