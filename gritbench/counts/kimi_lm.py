"""Model operations of one caption batch of the language-model captioner,
and the bytes and operations of its grouped GEMMs, from the configuration's
widths (multiply-adds times two; bytes each read or write once).

A batch is: the visual stack (``counts/caption.py::vision_flops``), the two
projectors over the region and grid slots, the prefill of the prefix and
BOS (``P = R + G + 1`` slots an image, causal: slot i attends i + 1 slots),
the first word's head on BOS, and ``steps`` decode steps over ``batch *
beam`` rows, each absorbed MLA against the ``P + t`` latents before it, the
MLP, and the head.  A MoE layer's routed experts count ``k`` SwiGLUs a row;
the router and the shared experts count in full.
"""

from __future__ import annotations

from gritbench.counts import caption as caption_counts


def _mla_row(lm: dict) -> float:
    """The projections of one row through one MLA (no attention)."""
    d, h = lm["hidden_size"], lm["num_attention_heads"]
    nope, rope, v, rank = (lm["qk_nope_head_dim"], lm["qk_rope_head_dim"], lm["v_head_dim"],
                           lm["kv_lora_rank"])
    return 2.0 * d * (h * (nope + rope) + rank + rope) + 2.0 * h * v * d


def _mlp_row(lm: dict, moe: bool) -> float:
    d = lm["hidden_size"]
    if not moe:
        return 2.0 * 3 * d * lm["intermediate_size"]
    i, e = lm["moe_intermediate_size"], lm["n_routed_experts"]
    return (2.0 * d * e + 2.0 * 3 * d * i * lm["num_experts_per_tok"]
            + 2.0 * 3 * d * i * lm["n_shared_experts"])


def moe_layers(lm: dict) -> list[bool]:
    first, freq = lm["first_k_dense_replace"], lm["moe_layer_freq"]
    return [i >= first and (i - first) % freq == 0 for i in range(lm["num_hidden_layers"])]


def params(lm: dict) -> int:
    """The language model's parameters."""
    d, v, h = lm["hidden_size"], lm["vocab_size"], lm["num_attention_heads"]
    nope, rope, vd, rank = (lm["qk_nope_head_dim"], lm["qk_rope_head_dim"], lm["v_head_dim"],
                            lm["kv_lora_rank"])
    mla = d * h * (nope + rope) + d * (rank + rope) + rank + rank * h * (nope + vd) + h * vd * d
    e, i = lm["n_routed_experts"], lm["moe_intermediate_size"]
    moe = e * 3 * d * i + e * d + e + 3 * d * i * lm["n_shared_experts"]
    layers = sum(mla + 2 * d + (moe if m else 3 * d * lm["intermediate_size"])
                 for m in moe_layers(lm))
    return 2 * v * d + d + layers


def prefill_flops(lm: dict, batch: int, slots: int) -> float:
    """The prefill of ``slots`` causal slots an image (no head)."""
    h = lm["num_attention_heads"]
    nope, rope, v, rank = (lm["qk_nope_head_dim"], lm["qk_rope_head_dim"], lm["v_head_dim"],
                           lm["kv_lora_rank"])
    rows = batch * slots
    pairs = batch * slots * (slots + 1) / 2
    attn = (2.0 * rows * rank * h * (nope + v)              # K and V from the latent
            + 2.0 * pairs * h * (nope + rope + v))          # scores and P V
    return sum(rows * (_mla_row(lm) + _mlp_row(lm, m)) + attn for m in moe_layers(lm))


def decode_flops(lm: dict, rows: int, keys: int) -> float:
    """One absorbed decode step of ``rows`` rows against ``keys`` latents
    each, and the head."""
    h = lm["num_attention_heads"]
    nope, rope, v, rank = (lm["qk_nope_head_dim"], lm["qk_rope_head_dim"], lm["v_head_dim"],
                           lm["kv_lora_rank"])
    attn = (2.0 * h * nope * rank                   # q_nope into the latent
            + 2.0 * h * keys * (rank + rope) * 2    # scores and P [c | k_rope]
            + 2.0 * h * rank * v)                   # out of the latent
    per_row = sum(_mla_row(lm) + attn + _mlp_row(lm, m) for m in moe_layers(lm))
    return rows * (per_row + 2.0 * lm["hidden_size"] * lm["vocab_size"])


def projector_flops(cfg: dict, batch: int, slots: int) -> float:
    d_vis, d = cfg["model"]["d_model"], cfg["hidden_size"]
    return 2.0 * batch * slots * (d_vis * d_vis + d_vis * d)


def batch_flops(cfg: dict, traffic: dict, steps: int) -> float:
    """One batch: ``steps`` decode steps that ran the layers (step 0 reads
    the prefill's head)."""
    hw = tuple(traffic["bucket"])
    b, beam = traffic["batch"], traffic["beam_size"]
    lm = {k: cfg[k] for k in cfg if not isinstance(cfg[k], (dict, list))}
    vis_slots = cfg["model"]["detector"]["num_queries"] + caption_counts.level_tokens(cfg, hw)[-1]
    slots = vis_slots + 1
    total = caption_counts.vision_flops(cfg, b, hw) + projector_flops(cfg, b, vis_slots)
    total += prefill_flops(lm, b, slots) + 2.0 * b * lm["hidden_size"] * lm["vocab_size"]
    return total + sum(decode_flops(lm, b * beam, slots + t) for t in range(1, steps + 1))


def expert_dims(lm: dict) -> dict:
    return {"experts": lm["n_routed_experts"], "hidden": lm["hidden_size"],
            "width": lm["moe_intermediate_size"]}


def grouped_gemm_work(counts: list[int], dims: dict, elem_bytes: int) -> tuple[dict, dict]:
    """The operations and bytes of one MoE call's two grouped GEMMs, given
    its rows per expert: ({"gate_up": flops, "down": flops}, bytes alike).
    Weights count for the experts that got rows; gate+up reads its sorted
    rows and writes [gate | up], down reads h and writes its products, each
    in the compute type."""
    rows = sum(counts)
    hit = sum(1 for c in counts if c > 0)
    d, i = dims["hidden"], dims["width"]
    flops = {"gate_up": 2.0 * rows * d * 2 * i, "down": 2.0 * rows * i * d}
    nbytes = {"gate_up": elem_bytes * (hit * 2 * i * d + rows * d + rows * 2 * i),
              "down": elem_bytes * (hit * d * i + rows * i + rows * d)}
    return flops, nbytes
