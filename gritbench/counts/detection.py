"""Model operations of one detector pre-training step, from the
configuration's widths and the traffic's batch and bucket.

The forward is the detector of ``counts/caption.py`` (backbone, input
projections, deformable decoder) and the heads of every decoder level (the
class head and the three-layer box MLP on each of the layers + 1 levels).
A training step counts three forwards: the backward takes two, one for the
gradients of the activations and one for those of the weights.  Nothing
recomputed is counted (the port's backward of K2 and K10a recomputes their
forward: that is not model work).  The matcher's and the criterion's
element-wise work is left out.
"""

from __future__ import annotations

from gritbench.counts import caption, swin


def forward_flops(cfg: dict, batch: int, hw: tuple[int, int]) -> float:
    det = cfg["model"]["detector"]
    d, q = det["d_model"], det["num_queries"]
    levels = det["num_layers"] + 1
    heads = levels * 2.0 * batch * q * (d * det["num_classes"] + 2 * d * d + 4 * d)
    return caption.detector_flops(cfg, batch, hw) + heads


def step_flops(cfg: dict, traffic: dict) -> float:
    return 3.0 * forward_flops(cfg, traffic["batch"], tuple(traffic["bucket"]))


def gemm_launches(cfg: dict, traffic: dict) -> list[dict]:
    """The port's hand-written GEMM launches of one step: the backbone's
    training forward (its backward runs on the library's products)."""
    return swin.gemms(cfg["model"]["swin"], traffic["batch"], tuple(traffic["bucket"]),
                      train=True)
