"""The caption decode step replayed from CUDA graphs, on the card: a small
parallel decoder in bf16 (d_model 512, 8 heads, 3 layers, so that K11 runs),
beam search over two batches of visual inputs with the step issued op by op
(``decode_step_eager``) and through the graphs (``decode_step``: the first
batch captures them, the second replays them): the results equal bit for
bit, and K11's launch counter counts 3 a step in both.

Needs a CUDA card and skips without one.  This file imports no JAX, so that it
runs on a card's machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_graph_card.py
"""

from __future__ import annotations

import pytest
import torch

VOCAB, STEPS, BEAM, BATCH, LAYERS, D = 1000, 8, 5, 4, 3, 512


def _inputs(seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)

    def feat(n):
        return torch.randn((BATCH, n, D), generator=g, device="cuda").to(torch.bfloat16)

    gri_mask = torch.zeros((BATCH, 1, 1, 24), dtype=torch.bool, device="cuda")
    gri_mask[1::2, ..., 18:] = True
    return {"gri_feat": feat(24), "gri_mask": gri_mask, "reg_feat": feat(10),
            "reg_mask": torch.zeros((BATCH, 1, 1, 10), dtype=torch.bool, device="cuda")}


@pytest.mark.card
def test_graph_replay_equals_eager_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode step's graphs capture on the device")
    from grit_tpu_torch.decoding.beam_search import beam_search
    from grit_tpu_torch.models.cap_generator import CaptionGenerator
    from grit_tpu_torch.models.captioner import init_weights, to_compute_dtype
    from grit_tpu_torch.ops import decode_layer

    gen = CaptionGenerator(VOCAB, STEPS, LAYERS, 0, d_model=D, n_heads=8, d_ff=2048)
    init_weights(gen, torch.Generator().manual_seed(0))
    gen = to_compute_dtype(gen.cuda(), torch.bfloat16).eval()

    def search(step, vis):
        with torch.inference_mode():
            kv = gen.precompute_vis_kv(vis)
            before = decode_layer.LAUNCHES["decode_tail"]
            res = beam_search(
                lambda tok, t, v, c: step(tok, t, v, c, vis_kv=kv, vis_fold=BEAM),
                gen.init_cache(BATCH * BEAM, STEPS), vis, BATCH, BEAM, STEPS, 1, VOCAB,
                out_size=BEAM, return_margins=True)
            torch.cuda.synchronize()
            return res, decode_layer.LAUNCHES["decode_tail"] - before

    for seed in (1, 2):
        vis = _inputs(seed)
        ref, ref_n = search(gen.decode_step_eager, vis)
        got, got_n = search(gen.decode_step, vis)
        for name, a, b in zip(ref._fields, ref, got):
            assert a is None or torch.equal(a, b), name
        assert ref_n == got_n == LAYERS * STEPS
    assert len(gen.step_graphs.sets) == 1
