"""DETR-style set criterion: Hungarian matching + focal/L1/GIoU losses.

Math parity: reference models/detection/od_losses.py and
grit_tpu/detection/losses.py.

Targets arrive as padded tensors ``{labels [B, G], boxes [B, G, 4], valid
[B, G]}`` (G = max boxes per image), as ``datasets.pad_targets`` builds them.
The criterion computes the cost matrices of ALL prediction levels (final +
aux) in one stacked pass and solves every (level, image) problem in one go,
with one of two solvers (``match_impl``), as grit_tpu/detection/losses.py:
- ``"device"``: ``ops.lsa.linear_sum_assignment``, the JAX package's
  on-device solver (``_device_lsa_single``): one ``grit_lsa`` launch for all
  problems on a CUDA device, no host transfer; its plain version on the CPU;
- ``"host"``: scipy's ``linear_sum_assignment``, where the reference leaves it
  (od_losses.py:427-431): the costs go to the host in one transfer and the
  assignments come back in one, so a step waits for the device once, not
  once per level.
``"auto"`` (the config's default) is ``"device"`` for costs on a CUDA device
and ``"host"`` on the CPU, as the JAX package resolves it by backend
(losses.py:176-183).  Invalid (padding) columns get a +inf-like cost and are
dropped from the returned assignment.

Losses (od_losses.py:40-65, 91-116, 118-130, 206-227):
- classification: sigmoid focal (alpha=0.25, gamma=2) over a one-hot target
  where matched queries carry their class and unmatched are all-zero;
  normalized by ``num_boxes``;
- boxes: L1 + (1 - GIoU) on matched pairs, normalized by num_boxes;
- cardinality: |#(argmax != last class) - #gt| L1, logging only;
- attributes: the weighted BCE of od_losses.py:141-177 (inside/outside
  class-balance terms), used when attribute targets are present.

``num_boxes`` is the GLOBAL batch's count of ground-truth boxes, summed over
the ranks and then clamped to >= 1, as the reference's all-reduce
(od_losses.py:259-268) and grit_tpu's global count under GSPMD have it; the
attribute loss's positive and negative counts are global too.  Each rank's
losses are so its shares of the global batch's (the losses themselves on one
rank).  The matching stays per image, on each rank.  All losses are
computed in f32 whatever the model's compute dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from grit_tpu_torch.ops import lsa as lsa_ops
from grit_tpu_torch.parallel.mesh import global_sum
from grit_tpu_torch.utils.boxes import box_cxcywh_to_xyxy, generalized_box_iou

BIG_COST = 1e6


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable binary CE with logits."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Elementwise focal loss (no reduction)."""
    prob = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def dice_loss(logits, targets, num_boxes):
    """DICE/F-1 mask loss (od_losses.py:22-37); masks flattened per box."""
    probs = torch.sigmoid(logits).reshape(logits.shape[0], -1)
    targets = targets.reshape(targets.shape[0], -1)
    numerator = 2 * (probs * targets).sum(-1)
    denominator = probs.sum(-1) + targets.sum(-1)
    return (1 - (numerator + 1) / (denominator + 1)).sum() / num_boxes


def accuracy(logits, labels, topk: int = 1):
    """Top-k accuracy in percent (utils/misc.py:469); logging helper."""
    if logits.shape[0] == 0:
        return torch.zeros((), device=logits.device)
    pred = logits.topk(topk, dim=-1).indices
    return (pred == labels[:, None]).any(1).float().mean() * 100.0


def _host_lsa(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Batched host-side Hungarian.  cost [B, Q, G], n_valid [B] -> assign
    [B, G] (-1 on padding columns)."""
    from scipy.optimize import linear_sum_assignment

    b, _, g = cost.shape
    out = np.full((b, g), -1, np.int64)
    for i in range(b):
        n = int(n_valid[i])
        if n == 0:
            continue
        rows, cols = linear_sum_assignment(cost[i, :, :n])
        out[i, cols] = rows
    return out


@torch.no_grad()
def matching_cost(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid, *,
                  cost_class: float = 2.0, cost_bbox: float = 5.0,
                  cost_giou: float = 2.0) -> torch.Tensor:
    """Cost matrices [..., B, Q, G] of predictions ``pred_logits [..., B, Q,
    C]`` / ``pred_boxes [..., B, Q, 4]`` (any leading level axes) against the
    padded targets: focal-style class cost + L1 + (-GIoU)
    (od_losses.py:412-426), BIG_COST on padding columns and where a cost is
    not finite."""
    alpha, gamma = 0.25, 2.0
    lead = pred_logits.shape[:-3]
    labels = tgt_labels.long()[:, None, :].expand(*lead, -1, pred_logits.shape[-2], -1)
    # the class columns of each gt: [..., B, Q, G] (elementwise, so gathering first is the same)
    prob = torch.sigmoid(torch.gather(pred_logits.float(), -1, labels))
    neg = (1 - alpha) * prob ** gamma * (-torch.log(1 - prob + 1e-8))
    pos = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    boxes = pred_boxes.float()
    tgt = tgt_boxes.float()
    l1 = (boxes[..., :, None, :] - tgt[:, None, :, :]).abs().sum(-1)
    giou = generalized_box_iou(box_cxcywh_to_xyxy(boxes),
                               box_cxcywh_to_xyxy(tgt).expand(*lead, -1, -1, -1))
    cost = cost_bbox * l1 + cost_class * (pos - neg) - cost_giou * giou
    cost = torch.where(tgt_valid.bool()[:, None, :], cost, BIG_COST)
    return torch.nan_to_num(cost, nan=BIG_COST, posinf=BIG_COST, neginf=-BIG_COST)


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "device", "host"):
        raise ValueError(f"match_impl={impl!r}: expected 'auto', 'device' or 'host'")


def _resolve_impl(impl: str, device: torch.device) -> str:
    """'auto' -> the device solver on a CUDA device, scipy on the CPU (the JAX
    package's choice by backend)."""
    if impl == "auto":
        return "device" if device.type == "cuda" else "host"
    return impl


@torch.no_grad()
def hungarian_match(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid, *,
                    cost_class: float = 2.0, cost_bbox: float = 5.0, cost_giou: float = 2.0,
                    impl: str = "auto") -> torch.Tensor:
    """-> assign [..., B, G] (int64): the query matched to each gt box, -1 on
    padding; leading level axes of the predictions are solved together (one
    launch on the device, or one round trip to the host).  Matching carries
    no gradient (od_losses.py:401)."""
    _check_impl(impl)
    cost = matching_cost(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                         cost_class=cost_class, cost_bbox=cost_bbox, cost_giou=cost_giou)
    n_valid = tgt_valid.bool().sum(-1)
    b, q, g = cost.shape[-3:]
    flat = cost.reshape(-1, q, g)
    levels = flat.shape[0] // b
    if _resolve_impl(impl, cost.device) == "device":
        assign = lsa_ops.linear_sum_assignment(flat, n_valid.repeat(levels))
    else:
        host = torch.cat([cost.reshape(-1), n_valid.to(cost.dtype)]).cpu().numpy()  # one transfer
        flat, n_valid = host[:cost.numel()].reshape(-1, q, g), host[cost.numel():].astype(np.int64)
        assign = torch.from_numpy(_host_lsa(flat, np.tile(n_valid, levels))).to(cost.device)
    return torch.where(tgt_valid.bool(), assign.reshape(*cost.shape[:-3], b, g), -1)


class SetCriterion:
    """Functional set criterion: ``criterion(outputs, targets)`` -> losses,
    ``total_loss(losses)`` -> the weighted sum."""

    def __init__(self, num_classes: int, *, focal_alpha: float = 0.25, cost_class: float = 2.0,
                 cost_bbox: float = 5.0, cost_giou: float = 2.0,
                 weight_dict: Optional[dict] = None, match_impl: str = "auto"):
        _check_impl(match_impl)
        self.num_classes = num_classes
        self.focal_alpha = focal_alpha
        self.cost = dict(cost_class=cost_class, cost_bbox=cost_bbox, cost_giou=cost_giou,
                         impl=match_impl)
        self.weight_dict = weight_dict or {
            "loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0, "loss_attr": 1.0}

    def _single_level(self, pred_logits, pred_boxes, targets, num_boxes, assign=None):
        labels, valid = targets["labels"].long(), targets["valid"].bool()
        tgt_boxes = targets["boxes"].float()
        if assign is None:
            assign = hungarian_match(pred_logits, pred_boxes, labels, tgt_boxes, valid,
                                     **self.cost)
        pred_logits, pred_boxes = pred_logits.float(), pred_boxes.float()
        b, q, c = pred_logits.shape
        matched = assign >= 0
        safe_assign = torch.where(matched, assign, 0)

        # classification: each gt's class onto its assigned query row
        bidx = torch.arange(b, device=assign.device)[:, None].expand_as(assign)
        onehot = torch.zeros_like(pred_logits)
        onehot.index_put_((bidx, safe_assign, labels), matched.to(onehot.dtype), accumulate=True)
        onehot = onehot.clamp(0, 1)
        loss_ce = sigmoid_focal_loss(pred_logits, onehot, self.focal_alpha).sum() / num_boxes

        # boxes
        src_boxes = torch.gather(pred_boxes, 1, safe_assign[..., None].expand(-1, -1, 4))
        l1 = torch.where(matched, (src_boxes - tgt_boxes).abs().sum(-1), 0.0)
        giou = generalized_box_iou(box_cxcywh_to_xyxy(src_boxes)[:, :, None],
                                   box_cxcywh_to_xyxy(tgt_boxes)[:, :, None])[..., 0, 0]
        giou_l = torch.where(matched, 1 - giou, 0.0)

        # cardinality and class error (logging)
        with torch.no_grad():
            card_pred = (pred_logits.argmax(-1) != c - 1).sum(-1)
            card_err = (card_pred.float() - valid.sum(-1).float()).abs().mean()
            matched_logits = torch.gather(pred_logits, 1, safe_assign[..., None].expand(-1, -1, c))
            correct = (matched_logits.argmax(-1) == labels) & matched
            class_err = 100.0 * (1.0 - correct.sum() / matched.sum().clamp(min=1))
        out = {"loss_ce": loss_ce, "loss_bbox": l1.sum() / num_boxes,
               "loss_giou": giou_l.sum() / num_boxes, "cardinality_error": card_err,
               "class_error": class_err}
        return out, assign

    def attribute_loss(self, attr_logits, targets, assign):
        """Weighted BCE on matched queries (od_losses.py:141-177)."""
        has_attr = targets.get("has_attr")
        if has_attr is None:
            has_attr = torch.ones(assign.shape[0], dtype=torch.bool, device=assign.device)
        matched = ((assign >= 0) & has_attr.bool()[:, None])[..., None].float()
        safe_assign = torch.where(assign >= 0, assign, 0)
        logits = torch.gather(attr_logits.float(), 1,
                              safe_assign[..., None].expand(-1, -1, attr_logits.shape[-1]))
        tgt = targets["attributes"].float()
        bce = sigmoid_ce(logits, tgt) * matched
        n_pos, n_neg = global_sum(torch.stack([(tgt * matched).sum(),
                                               ((1 - tgt) * matched).sum()]))
        inside = torch.where(n_pos > 0, (bce * tgt).sum() / n_pos.clamp(min=1), 0.0)
        outside = torch.where(n_neg > 0, (bce * (1 - tgt)).sum() / n_neg.clamp(min=1), 0.0)
        return {"loss_attr": inside + outside}

    def match_levels(self, outputs: dict, targets: dict) -> torch.Tensor:
        """Assignments [L, B, G] of the final level (index 0) and every aux
        level, all solved together (``hungarian_match``)."""
        aux = outputs.get("aux_outputs", [])
        return hungarian_match(
            torch.stack([outputs["pred_logits"]] + [a["pred_logits"] for a in aux]),
            torch.stack([outputs["pred_boxes"]] + [a["pred_boxes"] for a in aux]),
            targets["labels"], targets["boxes"], targets["valid"], **self.cost)

    def __call__(self, outputs: dict, targets: dict, assigns=None, num_boxes=None) -> dict:
        """outputs: {pred_logits, pred_boxes, [aux_outputs], [attr_logits]} ->
        the per-loss dict (incl. per-aux-layer '_i' entries).  ``assigns``
        [L, B, G] replaces the matching (comparisons feed one arm's
        assignment to another).  ``num_boxes``: the box count to normalise
        by, where one process runs a global batch in parts (default: this
        batch's, summed over the ranks)."""
        if num_boxes is None:
            num_boxes = global_sum(targets["valid"].bool().sum().float())
        num_boxes = torch.as_tensor(num_boxes, dtype=torch.float32).clamp(min=1.0)
        aux = outputs.get("aux_outputs", [])
        if assigns is None:
            assigns = self.match_levels(outputs, targets)
        losses, assign = self._single_level(outputs["pred_logits"], outputs["pred_boxes"],
                                            targets, num_boxes, assign=assigns[0])
        if "attr_logits" in outputs and "attributes" in targets:
            losses.update(self.attribute_loss(outputs["attr_logits"], targets, assign))
        for i, aux_out in enumerate(aux):
            aux_losses, _ = self._single_level(aux_out["pred_logits"], aux_out["pred_boxes"],
                                               targets, num_boxes, assign=assigns[i + 1])
            losses.update({f"{k}_{i}": v for k, v in aux_losses.items()
                           if not k.endswith("_error")})  # logging keys: last layer only
        return losses

    def total_loss(self, losses: dict) -> torch.Tensor:
        total = 0.0
        for key, value in losses.items():
            base = key.rsplit("_", 1)[0] if key[-1].isdigit() else key
            if base in self.weight_dict:
                total = total + self.weight_dict[base] * value
        return total
