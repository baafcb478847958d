"""Detection-flavour detector: backbone + deformable decoder + prediction heads.

Parity: reference models/detection/detector.py (class Detector) and
heads.py:33-51 (AttrHead); grit_tpu/detection/detector.py.  Returns
``{pred_logits, pred_boxes, [aux_outputs], [attr_logits]}`` for the
``SetCriterion`` (grit_tpu_torch.detection.losses).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from grit_tpu_torch.models.captioner import init_weights, to_compute_dtype
from grit_tpu_torch.models.det_module import DetectionModule
from grit_tpu_torch.models.detector import Detector
from grit_tpu_torch.models.layers import Linear
from grit_tpu_torch.models.swin import SwinTransformer, build_swin


class AttrHead(nn.Module):
    """Attribute prediction from query states + predicted-class embedding."""

    def __init__(self, d_model: int, num_attr_classes: int, num_od_classes: int):
        super().__init__()
        self.od_cls_embed = nn.Embedding(num_od_classes, d_model)
        self.attr_linear1 = Linear(2 * d_model, d_model)
        self.attr_linear2 = Linear(d_model, num_attr_classes)

    def forward(self, obj_h: torch.Tensor, pred_logits: torch.Tensor) -> dict:
        best = pred_logits.argmax(-1)    # sigmoid is monotone: the same class
        cls_embed = self.od_cls_embed(best).to(obj_h.dtype)
        attr = self.attr_linear1(torch.cat([obj_h, cls_embed], -1))
        return {"attr_logits": self.attr_linear2(F.relu(attr))}


class DetectionDetector(Detector):
    """The caption flavour's backbone, input projections and deformable
    decoder (``models.detector.Detector``: on-device normalize, four 1x1 conv
    + GroupNorm(32) projections), followed by the detection head and the
    optional attribute head.  Evaluation (``eval()``) predicts from the last
    decoder level only; training returns every level (``aux_outputs``)."""

    def __init__(self, backbone: SwinTransformer, det_module: DetectionModule,
                 hidden_dim: int = 512, has_attr_head: bool = False,
                 num_attr_classes: int = 400, num_od_classes: int = 1849):
        super().__init__(backbone, det_module, hidden_dim)
        self.attr_head = (AttrHead(hidden_dim, num_attr_classes, num_od_classes)
                          if has_attr_head else None)

    def forward(self, images, *, training: Optional[bool] = None) -> dict:
        training = self.training if training is None else training
        hs, init_ref, inter_refs = self.decode(images)[:3]
        outputs = self.det_module.detection_head(hs, init_ref, inter_refs, training=training)
        if self.attr_head is not None:
            outputs.update(self.attr_head(hs[-1], outputs["pred_logits"]))
        return outputs


def build_detection_model(config, dtype: Optional[torch.dtype] = None, *, device=None,
                          seed: Optional[int] = 0):
    """(model, criterion) from a detection config (reference detector.py:126-157).

    The model is built on ``device`` (default: the GPU; raises without one) in
    ``train()``, with f32 master parameters that compute in ``dtype`` (None:
    f32, as the JAX package's CLI builds it).  ``seed`` draws random weights;
    load a checkpoint over them.

    ``model.detector.with_box_refine`` is accepted and, as in the JAX package,
    changes nothing: its ``DetectionModule`` takes the flag
    (grit_tpu/models/det_module.py:285) and never reads it, so either value
    builds the same refining model."""
    from grit_tpu_torch.detection.losses import SetCriterion

    det_cfg = config.model.detector
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_detection_model: no CUDA device is available "
                           "(pass device='cpu' to build on the CPU)")
    with device:
        backbone = build_swin(config.model.get("backbone", "swin_base_win7_384_22k"),
                              frozen_stages=int(config.model.get("frozen_stages", -1)),
                              use_checkpoint=bool(config.model.get("use_checkpoint", False)))
        det_module = DetectionModule(
            d_model=det_cfg.d_model, n_heads=det_cfg.num_heads, num_layers=det_cfg.num_layers,
            dim_feedforward=det_cfg.dim_feedforward, num_levels=det_cfg.num_levels,
            num_points=det_cfg.num_points, num_classes=det_cfg.num_classes,
            num_queries=det_cfg.num_queries, dropout=det_cfg.dropout)
        model = DetectionDetector(
            backbone, det_module, hidden_dim=det_cfg.d_model,
            has_attr_head=bool(config.model.get("with_attributes", False)),
            num_attr_classes=config.model.get("num_attr_classes", 400),
            num_od_classes=det_cfg.num_classes)
    if seed is not None:
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    to_compute_dtype(model, dtype or torch.float32, master_f32=True).train()
    loss_cfg = config.model.losses
    criterion = SetCriterion(
        det_cfg.num_classes, focal_alpha=loss_cfg.focal_alpha,
        cost_class=loss_cfg.set_cost_class, cost_bbox=loss_cfg.set_cost_bbox,
        cost_giou=loss_cfg.set_cost_giou, match_impl=loss_cfg.get("match_impl", "auto"),
        weight_dict={"loss_ce": loss_cfg.cls_loss_coef, "loss_bbox": loss_cfg.bbox_loss_coef,
                     "loss_giou": loss_cfg.giou_loss_coef, "loss_attr": loss_cfg.attr_loss_coef})
    return model, criterion
