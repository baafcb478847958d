"""Bounding-box utilities (cxcywh <-> xyxy, IoU, GIoU).

Math parity: reference utils/box_ops.py:17-96 and grit_tpu/utils/boxes.py.
Boxes are ``[..., 4]`` tensors, either ``(cx, cy, w, h)`` or
``(x0, y0, x1, y1)``.
"""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU between [..., N, 4] and [..., M, 4] xyxy boxes ->
    ([..., N, M], union [..., N, M]); leading axes batch."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU [..., N, M] for xyxy boxes (reference utils/box_ops.py:41-69)."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """Tight xyxy boxes around binary masks [N, H, W] (utils/box_ops.py:72-96).
    Empty masks produce a zero box."""
    _, h, w = masks.shape
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None, None, :]
    on = masks.float() > 0
    big = 1e8
    x_min = torch.where(on, xs, big).amin((1, 2))
    x_max = torch.where(on, xs, -big).amax((1, 2))
    y_min = torch.where(on, ys, big).amin((1, 2))
    y_max = torch.where(on, ys, -big).amax((1, 2))
    box = torch.stack([x_min, y_min, x_max, y_max], dim=1)
    return torch.where(on.any(2).any(1)[:, None], box, 0.0)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """logit with the reference's clamping (utils/misc.py:516)."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))
