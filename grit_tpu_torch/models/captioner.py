"""GRIT captioner: detector -> grid network -> caption generator.

Math parity: reference models/caption/transformer.py (class Transformer).
Decoding runs through ``grit_tpu_torch.decoding.beam_search`` with the
single-token ``decode_step`` and fixed-shape KV caches.
"""

from __future__ import annotations

import torch
from torch import nn

from grit_tpu_torch.models.cap_generator import CaptionGenerator, DecodeCache
from grit_tpu_torch.models.det_module import (DetectionModule, MSDeformAttnModule,
                                              SelfAttention, msda_offset_bias)
from grit_tpu_torch.models.detector import Detector
from grit_tpu_torch.models.grid_net import GridFeatureNetwork
from grit_tpu_torch.models.swin import build_swin
from grit_tpu_torch.ops.posemb import sinusoid_encoding_table
from grit_tpu_torch.utils.nested import ImageBatch


class GRITCaptioner(nn.Module):
    def __init__(self, detector: Detector, grid_net: GridFeatureNetwork,
                 cap_generator: CaptionGenerator):
        super().__init__()
        self.detector = detector
        self.grid_net = grid_net
        self.cap_generator = cap_generator

    def compute_vis(self, images: ImageBatch) -> dict:
        """Detector + grid network -> gri_feat/gri_mask/reg_feat/reg_mask."""
        vis = self.detector(images)
        gri, _ = self.grid_net(vis["gri_feat"], vis["gri_mask"])
        vis["gri_feat"] = gri[:, -1]
        return vis

    def precompute_vis_kv(self, vis_inputs: dict):
        return self.cap_generator.precompute_vis_kv(vis_inputs)

    def decode_step(self, token, t: int, vis_inputs: dict, cache: DecodeCache, *,
                    vis_kv, vis_fold: int = 1):
        return self.cap_generator.decode_step(token, t, vis_inputs, cache,
                                              vis_kv=vis_kv, vis_fold=vis_fold)

    def init_cache(self, batch: int, t_max: int) -> DecodeCache:
        return self.cap_generator.init_cache(batch, t_max)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator``: xavier-uniform for every
    matrix (the reference's Transformer.init_weights), zero biases, unit
    norm scales, MSDA offsets at the radial init (ms_deform_attn.py:57-65)
    and the sinusoid position table."""
    for name, p in model.named_parameters():
        if p.dim() > 1:
            torch.nn.init.xavier_uniform_(p.view(p.shape[0], -1), generator=generator)
        elif name.endswith(".bias") or name.endswith("_bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    for mod in model.modules():
        if isinstance(mod, MSDeformAttnModule):
            mod.sampling_offsets.weight.zero_()
            mod.sampling_offsets.bias.copy_(torch.from_numpy(
                msda_offset_bias(mod.n_heads, mod.n_levels, mod.n_points)))
            mod.attention_weights.weight.zero_()
        elif isinstance(mod, CaptionGenerator):
            n, d = mod.pos_emb.weight.shape
            mod.pos_emb.weight.copy_(sinusoid_encoding_table(n, d, 0))
    return model


@torch.no_grad()
def to_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights and biases of every Linear and convolution (and the
    detector self-attention's packed in-projection) to ``dtype``.  Norm
    scales and biases, the relative-position bias tables and the embeddings
    stay f32.  These are flax's ``dtype=`` semantics: Dense and Conv cast
    kernel and bias to the compute dtype at every call (the same values each
    time); LayerNorm, GroupNorm and the tables are read in f32."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, SelfAttention)):
            for p in mod.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


def build_captioner(config, *, device=None, dtype: torch.dtype = torch.float32,
                    seed: int | None = 0) -> GRITCaptioner:
    """Assemble the captioner from a caption config (grit_tpu.config) on
    ``device``, computing in ``dtype`` (see ``to_compute_dtype``).  ``seed``
    draws random weights from a ``torch.Generator``; load a checkpoint over
    them with load_state_dict."""
    m = config.model
    det = m.detector
    if m.cap_generator.decoder_name != "parallel" or not (m.use_gri_feat and m.use_reg_feat):
        raise NotImplementedError(
            "only the 'parallel' decoder over grid and region features is ported")
    device = torch.device(device or "cpu")
    with device:
        backbone = build_swin(m.get("backbone", "swin_base_win7_384_22k"))
        det_module = DetectionModule(
            d_model=det.d_model, n_heads=det.num_heads, num_layers=det.num_layers,
            dim_feedforward=det.dim_feedforward, num_levels=det.num_levels,
            num_points=det.num_points, num_classes=det.num_classes,
            num_queries=det.num_queries)
        model = GRITCaptioner(
            Detector(backbone, det_module, hidden_dim=m.d_model),
            GridFeatureNetwork(m.grid_net.n_layers, d_in=m.grid_feat_dim,
                               d_model=m.d_model, n_heads=m.n_heads),
            CaptionGenerator(m.vocab_size, m.max_len, m.cap_generator.n_layers, m.pad_idx,
                             d_model=m.d_model, n_heads=m.n_heads,
                             replicate_alpha_bug=bool(m.get("replicate_alpha_bug", True))))
    if seed is not None:
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return to_compute_dtype(model, dtype).eval()
