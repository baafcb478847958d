"""Model operations of one caption batch (beam search), from the
configuration's widths and the traffic's batch, bucket, beam and steps.

What the model needs, forward only, in multiply-adds times two:

- the Swin backbone (``counts/swin.py``);
- the four 1x1 input projections;
- the deformable decoder: per layer, self-attention over the queries, the
  value projection over every level's tokens, the offsets and weights, the
  bilinear taps (4 corners a tap), the output projection and the FFN; the
  box MLP of each refinement;
- the grid network over the last map's tokens;
- the decoder: the visual K/V projected once a batch, and per step and beam
  the self-attention over the cached prefix, the two cross-attentions, the
  gates, the FFN and the vocabulary head.  ``steps`` is the number of steps
  the beam search ran (the program's count of decode-layer calls says it).
"""

from __future__ import annotations

from gritbench.counts import swin as swin_counts


def level_tokens(cfg: dict, hw: tuple[int, int]) -> list[int]:
    sw = cfg["model"]["swin"]
    n = len(sw["depths"])
    strides = [sw["patch_size"] * 2 ** s for s in range(1, n)] + [sw["patch_size"] * 2 ** n]
    return [-(-hw[0] // s) * -(-hw[1] // s) for s in strides]


def detector_flops(cfg: dict, batch: int, hw: tuple[int, int]) -> float:
    """The backbone, the input projections and the deformable decoder."""
    m = cfg["model"]
    sw, det = m["swin"], m["detector"]
    total = swin_counts.model_flops(sw, batch, hw)
    toks = level_tokens(cfg, hw)
    chans = [sw["embed_dim"] * 2 ** i for i in range(1, len(sw["depths"]))] + [sw["pos_dim"]]
    d = det["d_model"]
    total += sum(2.0 * batch * t * c * d for t, c in zip(toks, chans))
    q, s = det["num_queries"], sum(toks)
    taps = det["num_heads"] * det["num_levels"] * det["num_points"]
    dff = det["dim_feedforward"]
    box = 2.0 * batch * q * (2 * d * d + 4 * d)
    per_layer = (2.0 * batch * q * 4 * d * d + 2.0 * batch * 2 * q * q * d   # self-attention
                 + 2.0 * batch * s * d * d                                  # value projection
                 + 2.0 * batch * q * d * 3 * taps                           # offsets, weights
                 + 2.0 * batch * q * taps * (d // det["num_heads"]) * 4     # bilinear taps
                 + 2.0 * batch * q * d * d                                  # output projection
                 + 2.0 * batch * q * 2 * d * dff                            # FFN
                 + box)
    return total + det["num_layers"] * per_layer + box + 2.0 * batch * q * d * 2


def vision_flops(cfg: dict, batch: int, hw: tuple[int, int]) -> float:
    """The detector and the grid network over the last map's tokens."""
    m = cfg["model"]
    sw = m["swin"]
    total = detector_flops(cfg, batch, hw)
    g = level_tokens(cfg, hw)[-1]
    dm = m["d_model"]
    total += 2.0 * batch * g * sw["pos_dim"] * dm
    total += m["grid_layers"] * (2.0 * batch * g * 4 * dm * dm + 2.0 * batch * 2 * g * g * dm
                                 + 2.0 * batch * g * 2 * dm * m["d_ff"])
    return total


def decode_flops(cfg: dict, batch: int, hw: tuple[int, int], beam: int, steps: int) -> float:
    m = cfg["model"]
    dm, v = m["d_model"], m["vocab_size"]
    g, r = level_tokens(cfg, hw)[-1], m["detector"]["num_queries"]
    rows = batch * beam
    total = m["decoder_layers"] * 2.0 * batch * (g + r) * 2 * dm * dm      # visual K/V once
    for t in range(steps):
        per = (2.0 * rows * 4 * dm * dm + 2.0 * rows * 2 * (t + 1) * dm     # self-attention
               + 2 * 2.0 * rows * 2 * dm * dm                               # cross q and o
               + 2.0 * rows * 2 * (g + r) * dm                              # cross scores, PV
               + 2 * 2.0 * rows * 2 * dm * dm                               # the two gates
               + 2.0 * rows * 2 * dm * m["d_ff"])                           # FFN
        total += m["decoder_layers"] * per + 2.0 * rows * dm * v
    return total


def batch_flops(cfg: dict, traffic: dict, steps: int) -> float:
    hw = tuple(traffic["bucket"])
    b = traffic["batch"]
    return vision_flops(cfg, b, hw) + decode_flops(cfg, b, hw, traffic["beam_size"], steps)


def gemm_launches(cfg: dict, traffic: dict) -> list[dict]:
    """The port's hand-written GEMM launches of one batch: the backbone's."""
    return swin_counts.gemms(cfg["model"]["swin"], traffic["batch"], tuple(traffic["bucket"]))
