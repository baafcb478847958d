"""Caption-flavour detector: Swin backbone + deformable decoder -> dual features.

Math parity: reference models/caption/detector.py.
- grid features: the extra H/64 Swin map flattened, [B, (H/64)(W/64), 1024],
  with its pad mask as [B, 1, 1, S] (:54-55);
- region features: the last decoder layer's query states [B, 150, d_model]
  with an all-valid mask (:60-61);
- per-level 1x1 conv + GroupNorm(32) input projections (:28-33).
"""

from __future__ import annotations

import torch
from torch import nn

from grit_tpu_torch.models.det_module import DetectionModule
from grit_tpu_torch.models.layers import Conv2d
from grit_tpu_torch.models.norm import GroupNorm
from grit_tpu_torch.models.swin import SwinTransformer
from grit_tpu_torch.utils.nested import ImageBatch, device_normalize, downsample_mask


class Detector(nn.Module):
    def __init__(self, backbone: SwinTransformer, det_module: DetectionModule,
                 hidden_dim: int = 512):
        super().__init__()
        self.backbone = backbone
        self.det_module = det_module
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(c, hidden_dim, 1), GroupNorm(32, hidden_dim))
            for c in backbone.num_channels)

    def decode(self, images: ImageBatch):
        """-> (hs [n_layers+1, B, Lq, C], init_ref, inter_refs, the backbone's
        four maps, their pad masks)."""
        images = device_normalize(images)
        features = self.backbone(images.images)
        n_stages = len(self.backbone.depths)
        patch = self.backbone.patch_size
        strides = [patch * 2 ** s for s in range(1, n_stages)] + [patch * 2 ** n_stages]
        masks = [downsample_mask(images.mask, s) for s in strides]
        srcs = [proj(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                for proj, f in zip(self.input_proj, features)]
        return (*self.det_module(srcs, masks), features, masks)

    def forward(self, images: ImageBatch) -> dict:
        hs, _, _, features, masks = self.decode(images)
        b = hs.shape[1]
        return {"gri_feat": features[-1].reshape(b, -1, features[-1].shape[-1]),
                "gri_mask": masks[-1].reshape(b, 1, 1, -1),
                "reg_feat": hs[-1],
                "reg_mask": torch.zeros((b, 1, 1, hs.shape[2]), dtype=torch.bool,
                                        device=hs.device)}
