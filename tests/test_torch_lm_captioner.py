"""The language-model caption decoder (``model.cap_generator.decoder_name=
"mla_moe"``: ``models/lm_decoder.py``, ``models/lm_captioner.py``,
``ops/moe.py``) against the plain float32 reference
``gritbench/reference/kimi_lm.py``, at a tiny preset on the CPU (hidden 64,
4 heads, latent 32, rope 16 / nope 32 / v 32, 8 experts of which 2 a
token, 1 shared, layer 0 dense, 3 layers, vocabulary 97) with the
benchmark's seeded weights (``gritbench/lm_weights.py``).

Both sides compute in float32 on the CPU and differ only in the order of
their sums (the port's grouped and absorbed products against the
reference's per-expert, expanded ones), so each tolerance is a few float32
roundings of the compared quantity's scale.  The router's weights are
multiplied by ``ROUTER_GAIN`` on both sides: at the tiny width the sigmoid
scores lie so close together that a float32 rounding could flip a top-k
choice between two correct implementations; the gain keeps every choice's
margin far above that.
"""

from __future__ import annotations

import hashlib

import pytest
import torch

from gritbench import inputs
from gritbench.counts import kimi_lm as counts
from gritbench.lm_weights import LazyParams, load
from gritbench.reference import kimi_lm as ref
from gritbench.reference import vision as ref_vision
from gritbench.reference.nn import Arith
from gritbench.tests.tiny_lm import LM_CONFIG, LM_TINY, LM_TRAFFIC
from gritbench.traffic.caption_generate_lm import port_config
from grit_tpu_torch.config import KIMI_VL_A3B, default_caption_config
from grit_tpu_torch.engine.evaluator import make_caption_generator
from grit_tpu_torch.models.captioner import GRITCaptioner, build_captioner
from grit_tpu_torch.models.lm_captioner import LMCaptioner
from grit_tpu_torch.models.lm_decoder import MoE, Router
from grit_tpu_torch.ops import moe as moe_ops
from grit_tpu_torch.utils.nested import ImageBatch

SEED = 11
ROUTER_GAIN = 8.0
A = Arith("fp32")
M = LM_CONFIG["model"]
BOS, EOS = M["bos_idx"], M["eos_idx"]


class Setup:
    pass


@pytest.fixture(scope="module")
def tiny():
    s = Setup()
    model = build_captioner(port_config(LM_CONFIG), device="cpu", dtype=torch.float32,
                            seed=None)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    load(model, shapes, SEED, "cpu", det=M["detector"])
    s.P = dict(LazyParams(shapes, SEED, "cpu", det=M["detector"]))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".mlp.gate.weight"):
                p.mul_(ROUTER_GAIN)
                s.P[name] = s.P[name] * ROUTER_GAIN
    s.model = model.eval()
    imgs, pad = inputs.images(LM_TRAFFIC, inputs.generator(SEED, 17, "cpu"), "cpu")
    s.batch = ImageBatch(imgs, pad)
    with torch.no_grad():
        s.vis = model.compute_vis(s.batch)
        s.kv = model.precompute_vis_kv(s.vis)
        s.prefix, s.mask = ref.project(A, s.P, ref_vision.vision(A, s.P, imgs, pad, M))
    return s


def rel_err(p, r, keep):
    keep = keep.float()[..., None]
    err = ((p - r) * keep).flatten(1).norm(dim=1).max()
    return float(err / (r * keep).flatten(1).norm(dim=1).min())


def test_builds_the_language_model_captioner(tiny):
    assert isinstance(tiny.model, LMCaptioner)
    n_lm = sum(p.numel() for n, p in tiny.model.named_parameters()
               if n.startswith("language_model."))
    assert n_lm == counts.params(LM_TINY)
    moes = [m for m in tiny.model.modules() if isinstance(m, MoE)]
    assert len(moes) == 2 and moes[0].w13.shape == (8, 96, 64) and moes[0].w2.shape == (8, 64, 48)


def test_published_widths_on_meta():
    """At Kimi-VL-A3B's widths the language model has 15.96 B parameters,
    laid out without storage."""
    cfg = default_caption_config().apply_overrides(["model.cap_generator.decoder_name=mla_moe"])
    model = build_captioner(cfg, device="meta", dtype=torch.bfloat16, seed=None)
    lm = {n: p for n, p in model.named_parameters() if n.startswith("language_model.")}
    n = sum(p.numel() for p in lm.values())
    assert n == counts.params(KIMI_VL_A3B)
    assert 15.95e9 < n < 15.97e9
    assert lm["language_model.layers.1.mlp.w13"].dtype == torch.bfloat16
    assert lm["language_model.layers.1.mlp.gate.weight"].dtype == torch.float32
    assert lm["language_model.embed_tokens.weight"].shape == (163840, 2048)


def test_default_config_keeps_the_grit_decoder():
    """The default caption config still builds GRIT's parallel decoder with
    the parameter names, shapes and types it had before the language-model
    decoder existed (their digest)."""
    model = build_captioner(default_caption_config(), device="meta", seed=None)
    assert type(model) is GRITCaptioner
    assert model.cap_generator.decoder_name == "parallel"
    s = ";".join(f"{n}:{tuple(p.shape)}:{p.dtype}" for n, p in model.named_parameters())
    assert hashlib.sha256(s.encode()).hexdigest() == (
        "2763c518333ba3e5f41ae65a5193ffd18abb90f3ca0498118014c5188366c355")


def test_visual_tokens_and_prefill(tiny):
    """The projector's tokens, the last layer's prefix latents and the first
    word's log-probs (f32 sums in another order: 1e-5 of their scale)."""
    n_vis = tiny.prefix.shape[1]
    real = ~tiny.mask
    with torch.no_grad():
        tokens, mask = tiny.model.projector(tiny.vis)
    assert torch.equal(mask, tiny.mask)
    assert rel_err(tokens, tiny.prefix, real) < 1e-5
    bos = torch.full((tiny.prefix.shape[0], 1), BOS, dtype=torch.long)
    out = ref.forward(A, tiny.P, tiny.prefix, tiny.mask, bos, LM_TINY)
    assert rel_err(tiny.kv["latents"][-1][:, :n_vis], out["latent"], real) < 1e-5
    first = ref.log_probs(A, tiny.P, out["hidden"][:, -1], LM_TINY)
    assert float((tiny.kv["first"] - first).abs().max()) < 1e-5


@pytest.mark.parametrize("fold", [1, 3])
def test_cached_decode_matches_full_forward(tiny, fold):
    """Step by step through the per-image latent prefix (beams folded) and
    the per-beam cache, absorbed, against the reference's full causal
    forward, expanded: log-probs of every position within 2e-5 (values near
    -log 97 = -4.6, f32)."""
    b, length = tiny.prefix.shape[0], 5
    gen = torch.Generator().manual_seed(fold)
    ids = torch.randint(0, LM_TINY["vocab_size"], (b * fold, length), generator=gen)
    ids[:, 0] = BOS
    full = ref.log_probs(A, tiny.P, ref.forward(A, tiny.P, tiny.prefix, tiny.mask, ids, LM_TINY,
                                                fold=fold)["hidden"], LM_TINY)
    cache = tiny.model.init_cache(b * fold, length)
    with torch.no_grad():
        for t in range(length):
            lp, cache = tiny.model.decode_step(ids[:, t:t + 1], t, tiny.vis, cache,
                                               vis_kv=tiny.kv, vis_fold=fold)
            assert float((lp - full[:, t]).abs().max()) < 2e-5, t


def test_teacher_forcing_matches_reference(tiny):
    """The port's own full forward (un-absorbed, no cache) against the
    reference's."""
    b = tiny.prefix.shape[0]
    ids = torch.randint(0, LM_TINY["vocab_size"], (b, 6),
                        generator=torch.Generator().manual_seed(5))
    ids[:, 0] = BOS
    with torch.no_grad():
        lp = tiny.model(tiny.batch, ids)
    full = ref.log_probs(A, tiny.P, ref.forward(A, tiny.P, tiny.prefix, tiny.mask, ids,
                                                LM_TINY)["hidden"], LM_TINY)
    assert float((lp - full).abs().max()) < 2e-5


def _router(tiny):
    return next(m for m in tiny.model.modules() if isinstance(m, Router))


@pytest.mark.parametrize("bias_scale", [0.0, 1.0])
def test_router_matches_reference(tiny, bias_scale):
    """The same experts and weights as the reference, with the seed's
    correction bias and without it."""
    router = _router(tiny)
    name = next(n for n, m in tiny.model.named_modules() if m is router)[:-len(".gate")]
    x = torch.randn(40, LM_TINY["hidden_size"], generator=torch.Generator().manual_seed(2))
    P = dict(tiny.P)
    bias = name + ".gate.e_score_correction_bias"
    P[bias] = P[bias] * bias_scale
    with torch.no_grad():
        saved = router.e_score_correction_bias.clone()
        router.e_score_correction_bias.mul_(bias_scale)
        idx, w = router(x)
        router.e_score_correction_bias.copy_(saved)
    ridx, rw = ref.route(P, name, x, LM_TINY)
    assert torch.equal(idx.sort(1).values, ridx.sort(1).values)
    order, rorder = idx.sort(1).indices, ridx.sort(1).indices
    assert torch.allclose(w.gather(1, order), rw.gather(1, rorder), atol=1e-6)


def test_correction_bias_chooses_but_does_not_weight(tiny):
    """A bias that forces one expert into every row's choice leaves the
    weights those of the sigmoid scores, normalised and scaled."""
    router = _router(tiny)
    x = torch.randn(16, LM_TINY["hidden_size"], generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        saved = router.e_score_correction_bias.clone()
        router.e_score_correction_bias.zero_()
        router.e_score_correction_bias[5] = 10.0
        idx, w = router(x)
        router.e_score_correction_bias.copy_(saved)
        scores = torch.sigmoid(x @ router.weight.t())
    assert bool((idx == 5).any(1).all())
    chosen = scores.gather(1, idx)
    expected = chosen / chosen.sum(1, keepdim=True) * LM_TINY["routed_scaling_factor"]
    assert torch.allclose(w, expected, atol=1e-6)


def test_sorted_experts_match_the_per_expert_loop(tiny):
    """The MoE layer's sort-by-expert path (``ops.moe``: gather, grouped
    products, scatter, sum over a row's slots) against the reference's loop
    over experts."""
    layer = next(n for n, m in tiny.model.named_modules() if isinstance(m, MoE))
    moe = tiny.model.get_submodule(layer)
    x = torch.randn(50, LM_TINY["hidden_size"], generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = moe(x)
    want = ref.moe(A, tiny.P, layer, x, LM_TINY)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())
    idx = torch.randint(0, 8, (50, 2), generator=torch.Generator().manual_seed(6))
    order, rows, counts_, offs = moe_ops.sort_by_expert(idx, 8)
    flat = idx.reshape(-1)[order]
    assert bool((flat[1:] >= flat[:-1]).all())
    assert torch.equal(offs[1:].long(), torch.cumsum(counts_, 0))
    assert torch.equal(rows.long(), order // 2)


def test_grouped_gemm_matches_the_per_expert_loop():
    """In bf16 the routed experts' two products go through the library's
    grouped GEMM (``torch._grouped_mm``), one call each, counted; they hold
    to the same arithmetic expert by expert in f32 on the same bf16 inputs
    within 1e-2 of the output's scale (bf16 roundings of [gate | up], of h
    and of the products, ~4e-3 each), with an expert that got no row."""
    g = torch.Generator().manual_seed(12)
    e, d, i, n, k = 8, 64, 48, 40, 2
    x = torch.randn(n, d, generator=g).bfloat16()
    w13 = (torch.randn(e, 2 * i, d, generator=g) * 0.1).bfloat16()
    w2 = (torch.randn(e, d, i, generator=g) * 0.1).bfloat16()
    idx = torch.stack([torch.randperm(e - 1, generator=g)[:k] for _ in range(n)])
    w = torch.rand(n, k, generator=g)
    before = dict(moe_ops.LAUNCHES)
    got = moe_ops.routed_experts(x, idx, w, w13, w2)
    assert {n_: moe_ops.LAUNCHES[n_] - before[n_] for n_ in before} == {
        "moe_gate_up": 1, "moe_down": 1}
    want = moe_ops.routed_experts(x.float(), idx, w, w13.float(), w2.float())
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) < 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_search_matches_reference(tiny, beam):
    """``make_caption_generator`` (prefill, then the cached decode under
    ``beam_search``) chooses the reference's captions, whose every step is a
    whole forward."""
    generate = make_caption_generator(tiny.model, beam_size=beam, max_len=5, bos_idx=BOS,
                                      eos_idx=EOS)
    tokens = generate(tiny.batch, tiny.prefix.shape[0])
    want = ref.beam_search(A, tiny.P, tiny.prefix, tiny.mask, LM_TINY, beam=beam, steps=5,
                           bos=BOS, eos=EOS)
    assert torch.equal(tokens, want["tokens"])


def test_spans_and_expert_counter(tiny):
    """Under the profiler a tiny ``generate`` opens the four spans, and the
    expert counter records each MoE call's rows times top-k; without the
    profiler it records nothing."""
    from torch.profiler import ProfilerActivity, profile

    beam, steps = 3, 4
    b = tiny.prefix.shape[0]
    generate = make_caption_generator(tiny.model, beam_size=beam, max_len=steps + 1,
                                      bos_idx=BOS, eos_idx=EOS)
    moe_ops.take_expert_load()
    generate(tiny.batch, b)
    assert moe_ops.take_expert_load() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        generate(tiny.batch, b)
    names = {e.name for e in prof.events()}
    assert {"grit.lm_prefill", "grit.mla", "grit.moe", "grit.lm_head"} <= names
    loads = [int(c.sum()) for c in moe_ops.take_expert_load()]
    k, n_moe = LM_TINY["num_experts_per_tok"], 2
    slots = tiny.prefix.shape[1] + 1
    assert loads == [b * slots * k] * n_moe + [b * beam * k] * (n_moe * steps)


def test_reference_follows_the_program_only_at_ties(tiny):
    """The reference takes another computation's expert choices where they
    are a top-k within the tie, and keeps its own elsewhere: a hint that
    swaps the k-th expert for the next within the tie is taken, one that
    takes a far expert is not, nor a hint with another number of experts."""
    router = _router(tiny)
    name = next(n for n, m in tiny.model.named_modules() if m is router)[:-len(".gate")]
    x = torch.randn(30, LM_TINY["hidden_size"], generator=torch.Generator().manual_seed(8))
    scores = torch.sigmoid(x @ tiny.P[name + ".gate.weight"].t())
    choice = scores + tiny.P[name + ".gate.e_score_correction_bias"]
    ranked = choice.argsort(1, descending=True)
    own, _ = ref.route(tiny.P, name, x, LM_TINY)
    swap = torch.stack([ranked[:, 0], ranked[:, 2]], 1)     # 2nd best out, 3rd in
    gap = float((choice.gather(1, ranked[:, 1:2]) - choice.gather(1, ranked[:, 2:3])).max())
    stats = {}
    taken, _ = ref.route(tiny.P, name, x, LM_TINY, hint=swap, tie=gap + 1e-6, stats=stats)
    assert torch.equal(taken, swap) and stats["taken"] == 30
    kept, _ = ref.route(tiny.P, name, x, LM_TINY, hint=swap, tie=0.0)
    assert torch.equal(kept.sort(1).values, own.sort(1).values)
    far = torch.stack([ranked[:, 0], ranked[:, -1]], 1)
    far_gap = float((choice.gather(1, ranked[:, 1:2]) - choice.gather(1, ranked[:, -1:])).min())
    kept, _ = ref.route(tiny.P, name, x, LM_TINY, hint=far, tie=0.5 * far_gap)
    assert torch.equal(kept.sort(1).values, own.sort(1).values)
    kept, _ = ref.route(tiny.P, name, x, LM_TINY, hint=ranked[:, :1], tie=1.0)
    assert torch.equal(kept.sort(1).values, own.sort(1).values)


def test_inference_cli_with_the_language_model(tmp_path, capsys):
    """``inference_caption`` with the ``mla_moe`` overrides and no checkpoint:
    seed-0 weights, the caption as token ids of the language model."""
    from PIL import Image

    from grit_tpu_torch.inference_caption import main

    img = tmp_path / "img.png"
    Image.fromarray(torch.randint(0, 256, (50, 70, 3), dtype=torch.uint8,
                                  generator=torch.Generator().manual_seed(1)).numpy()).save(img)
    lm = [f"model.language_model.{k}={'null' if v is None else str(v).lower()}"
          for k, v in LM_TINY.items()]
    main(["--image", str(img), "--device", "cpu", "--beam", "2", *LM_CONFIG["port_overrides"],
          *lm, "model.beam_len=4", "dataset.transform_cfg.size=[64, 96]"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("Caption:")
    ids = [int(w) for w in line[len("Caption:"):].split()]
    assert len(ids) == 4 and all(0 <= i < LM_TINY["vocab_size"] for i in ids)
