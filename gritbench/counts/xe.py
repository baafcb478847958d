"""Model operations of one XE training step of the captioner, from the
configuration's widths and the traffic's batch, bucket and caption length.

The forward is the detector and the grid network (``counts/caption.py``)
and the teacher-forced decoder over the captions' L positions: per layer
the self-attention (causal, counted whole), the two cross-attentions with
their K/V projected from the image's grid and region tokens, the two gates
and the FFN; then the vocabulary head.  The parts that train count three
forwards (the backward takes two); the frozen parts (the patch embedding
and the Swin stages the configuration freezes) count their forward alone.
Nothing recomputed is counted.
"""

from __future__ import annotations

from gritbench.counts import caption, swin


def decoder_flops(cfg: dict, batch: int, hw: tuple[int, int], length: int) -> float:
    m = cfg["model"]
    d, v, dff = m["d_model"], m["vocab_size"], m["d_ff"]
    g, r = caption.level_tokens(cfg, hw)[-1], m["detector"]["num_queries"]
    rows = batch * length
    per = (2.0 * rows * 4 * d * d + 2.0 * batch * 2 * length * length * d    # self-attention
           + 2 * 2.0 * rows * 2 * d * d                                     # cross q and o
           + 2.0 * batch * (g + r) * 2 * d * d                              # cross k and v
           + 2.0 * rows * 2 * (g + r) * d                                   # cross scores, PV
           + 2 * 2.0 * rows * 2 * d * d                                     # the two gates
           + 2.0 * rows * 2 * d * dff)                                      # FFN
    return m["decoder_layers"] * per + 2.0 * rows * d * v


def frozen_flops(cfg: dict, batch: int, hw: tuple[int, int]) -> float:
    """The patch embedding and the frozen stages' blocks and merges."""
    sw = cfg["model"]["swin"]
    fs = cfg["model"]["frozen_stages"]
    n = max(0, fs - 1)
    if fs < 0:
        return 0.0
    part = dict(sw, depths=sw["depths"][:n] or [0])
    if n == 0:
        h0, w0 = hw[0] // sw["patch_size"], hw[1] // sw["patch_size"]
        return 2.0 * batch * h0 * w0 * sw["embed_dim"] * 3 * sw["patch_size"] ** 2
    return swin.model_flops(part, batch, hw)


def step_flops(cfg: dict, traffic: dict) -> float:
    hw, b = tuple(traffic["bucket"]), traffic["batch"]
    length = traffic["caption_tokens"][1] + 2
    total = caption.vision_flops(cfg, b, hw) + decoder_flops(cfg, b, hw, length)
    fz = frozen_flops(cfg, b, hw)
    return fz + 3.0 * (total - fz)


def gemm_launches(cfg: dict, traffic: dict) -> list[dict]:
    """The backbone's GEMM launches of one step: the frozen stages' as in
    evaluation, the others' as in training."""
    sw = cfg["model"]["swin"]
    hw, b = tuple(traffic["bucket"]), traffic["batch"]
    n = max(0, cfg["model"]["frozen_stages"] - 1)
    ev, tr = swin.gemms(sw, b, hw), swin.gemms(sw, b, hw, train=True)
    cut = sum(4 * d + 1 for d in sw["depths"][:n])
    return ev[:cut] + tr[cut:]
