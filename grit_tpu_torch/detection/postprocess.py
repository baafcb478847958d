"""Detection post-processing: top-100 sigmoid scores -> absolute xyxy boxes.

Parity: reference models/detection/od_losses.py:326-356 (PostProcess).
"""

from __future__ import annotations

import torch

from grit_tpu_torch.utils.boxes import box_cxcywh_to_xyxy


@torch.no_grad()
def postprocess(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                target_sizes: torch.Tensor) -> dict:
    """pred_logits [B, Q, C], pred_boxes [B, Q, 4] cxcywh in [0, 1],
    target_sizes [B, 2] (h, w) -> scores / labels / boxes [B, 100, ...] (the
    top 100 over queries x classes, od_losses.py:340; all Q*C where a tiny
    model has fewer)."""
    b, q, c = pred_logits.shape
    prob = torch.sigmoid(pred_logits.float()).reshape(b, q * c)
    scores, idx = prob.topk(min(100, q * c), dim=1)
    boxes = box_cxcywh_to_xyxy(pred_boxes.float())
    boxes = torch.gather(boxes, 1, (idx // c)[..., None].expand(-1, -1, 4))
    sizes = torch.as_tensor(target_sizes, device=boxes.device).float()
    img_h, img_w = sizes[:, 0], sizes[:, 1]
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)[:, None, :]
    return {"scores": scores, "labels": idx % c, "boxes": boxes * scale}
