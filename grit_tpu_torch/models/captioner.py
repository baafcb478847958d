"""GRIT captioner: detector -> grid network -> caption generator.

Math parity: reference models/caption/transformer.py (class Transformer).
``forward(images, seq)`` is the teacher-forced training path; decoding runs
through ``grit_tpu_torch.decoding.beam_search`` with the single-token
``decode_step`` and fixed-shape KV caches.
"""

from __future__ import annotations

import torch
from torch import nn

from grit_tpu_torch.models.cap_generator import CaptionGenerator, DecodeCache
from grit_tpu_torch.models.det_module import (DetectionModule, MSDeformAttnModule,
                                              SelfAttention, msda_offset_bias)
from grit_tpu_torch.models.detector import Detector
from grit_tpu_torch.models.grid_net import GridFeatureNetwork
from grit_tpu_torch.models.layers import set_generator
from grit_tpu_torch.models.lm_decoder import LanguageModel
from grit_tpu_torch.models.swin import SwinTransformer, build_swin
from grit_tpu_torch.ops.posemb import sinusoid_encoding_table
from grit_tpu_torch.utils.nested import ImageBatch


class GRITCaptioner(nn.Module):
    def __init__(self, detector: Detector, grid_net: GridFeatureNetwork,
                 cap_generator: CaptionGenerator):
        super().__init__()
        self.detector = detector
        self.grid_net = grid_net
        self.cap_generator = cap_generator

    def compute_vis(self, images) -> dict:
        """Detector (unless given a dict of cached detector features) + grid
        network -> gri_feat/gri_mask/reg_feat/reg_mask.  Cached features
        (numpy or tensors; the freezing mode's hdf5 stores float16) move to
        the model's device and its compute dtype, as grit_tpu's layers cast
        them through their ``dtype``."""
        if isinstance(images, ImageBatch):
            vis = self.detector(images)
        else:
            device, dtype = self._feature_place()
            vis = {}
            for k, v in images.items():
                v = torch.as_tensor(v, device=device)
                vis[k] = v.to(dtype) if v.is_floating_point() else v
        gri, _ = self.grid_net(vis["gri_feat"], vis["gri_mask"])
        vis["gri_feat"] = gri[:, -1]
        return vis

    def _feature_place(self):
        """(device, compute dtype) of the decoder, for cached features."""
        gen = self.cap_generator
        return gen.word_emb.weight.device, gen._dtype()

    def forward(self, images: ImageBatch, seq: torch.Tensor, fold: int = 1) -> torch.Tensor:
        """Teacher forcing: images and int captions [B * fold, L] -> log-probs
        [B * fold, L, V]; ``fold`` captions score against each image's
        features, computed once (the SCST update re-scores its beams: going
        through ``forward`` lets a ``DistributedDataParallel`` wrapper see
        it)."""
        vis = self.compute_vis(images)
        if fold > 1:
            vis = {name: x.repeat_interleave(fold, dim=0) for name, x in vis.items()}
        return self.cap_generator(seq, vis)

    def set_generator(self, generator) -> "GRITCaptioner":
        """Draw every dropout and drop-path mask from ``generator`` (None:
        torch's global generator)."""
        return set_generator(self, generator)

    def precompute_vis_kv(self, vis_inputs: dict):
        return self.cap_generator.precompute_vis_kv(vis_inputs)

    def decode_step(self, token, t: int, vis_inputs: dict, cache: DecodeCache, *,
                    vis_kv=None, vis_fold: int = 1):
        return self.cap_generator.decode_step(token, t, vis_inputs, cache,
                                              vis_kv=vis_kv, vis_fold=vis_fold)

    def init_cache(self, batch: int, t_max: int) -> DecodeCache:
        return self.cap_generator.init_cache(batch, t_max)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator``: xavier-uniform for every
    matrix (the reference's Transformer.init_weights), zero biases, unit
    norm scales, MSDA offsets at the radial init (ms_deform_attn.py:57-65),
    the detection heads' prior biases (``reset_head_parameters``), the
    sinusoid position table and a language model's own start
    (``LanguageModel.reset_parameters``)."""
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
        elif isinstance(mod, DetectionModule):
            mod.reset_head_parameters()
        elif isinstance(mod, CaptionGenerator):
            n, d = mod.pos_emb.weight.shape
            mod.pos_emb.weight.copy_(sinusoid_encoding_table(n, d, 0))
        elif isinstance(mod, LanguageModel):
            mod.reset_parameters(generator)
    return model


@torch.no_grad()
def to_compute_dtype(model: nn.Module, dtype: torch.dtype, *,
                     master_f32: bool = False) -> nn.Module:
    """Compute in ``dtype`` with flax's ``dtype=`` semantics: Dense and Conv
    use kernel and bias in the compute dtype; LayerNorm, GroupNorm, the
    relative-position bias tables and the embeddings are read in f32.

    For inference (``master_f32=False``) the weights and biases of every
    Linear and convolution (and the detector self-attention's packed
    in-projection) are rounded to ``dtype`` once, here.  For training
    (``master_f32=True``) every parameter stays f32 and the layers cast at
    each call, inside the graph (``models/layers.py``), so autograd returns
    f32 gradients to f32 parameters, as flax does."""
    if not master_f32:
        for mod in model.modules():
            if (isinstance(mod, (nn.Linear, nn.Conv2d, SelfAttention))
                    or getattr(mod, "stacked_linear", False)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(dtype)
    # the two modules that turn f32 inputs (images, embeddings) into activations
    for mod in model.modules():
        if isinstance(mod, (SwinTransformer, CaptionGenerator, LanguageModel)):
            mod.compute_dtype = dtype
    return model


def _device(device, who: str) -> torch.device:
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available "
                           "(pass device='cpu' to build on the CPU)")
    return device


def _detector(config) -> Detector:
    m = config.model
    det = m.detector
    backbone = build_swin(m.get("backbone", "swin_base_win7_384_22k"),
                          frozen_stages=int(m.get("frozen_stages", -1)),
                          use_checkpoint=bool(m.get("use_checkpoint", False)))
    det_module = DetectionModule(
        d_model=det.d_model, n_heads=det.num_heads, num_layers=det.num_layers,
        dim_feedforward=det.dim_feedforward, num_levels=det.num_levels,
        num_points=det.num_points, num_classes=det.num_classes,
        num_queries=det.num_queries, dropout=det.dropout)
    return Detector(backbone, det_module, hidden_dim=m.d_model)


def build_detector(config, *, device=None, dtype: torch.dtype = torch.float32,
                   seed: int | None = 0) -> Detector:
    """The captioner's detector alone (grit_tpu's ``build_detector``), in
    ``eval()`` with its weights rounded to ``dtype``, for feature extraction.
    ``seed`` draws the same weights as ``build_captioner``'s detector (its
    parameters come first in the captioner's)."""
    device = _device(device, "build_detector")
    with device:
        detector = _detector(config)
    if seed is not None:
        init_weights(detector, torch.Generator(device=device).manual_seed(seed))
    return to_compute_dtype(detector, dtype).eval()


def build_captioner(config, *, device=None, dtype: torch.dtype = torch.float32,
                    seed: int | None = 0, train: bool = False) -> GRITCaptioner:
    """Assemble the captioner from a caption config (grit_tpu_torch.config)
    on ``device`` (default: the GPU; raises without one), computing in
    ``dtype`` (see ``to_compute_dtype``).  ``seed`` draws random weights from
    a ``torch.Generator``; load a checkpoint over them with load_state_dict.
    ``train=True`` returns the model in ``train()`` with f32 master
    parameters; otherwise it is in ``eval()`` with its weights rounded to
    ``dtype``.  ``model.cap_generator.decoder_name="mla_moe"`` builds the
    language-model captioner instead (``lm_captioner.build_lm_captioner``;
    inference only)."""
    m = config.model
    if m.cap_generator.decoder_name == "mla_moe":
        from grit_tpu_torch.config import language_model_config
        from grit_tpu_torch.models.lm_captioner import build_lm_captioner

        return build_lm_captioner(config, language_model_config(m), device=device, dtype=dtype,
                                  seed=seed, train=train)
    if not (m.use_gri_feat and m.use_reg_feat):
        # grit_tpu's CaptionGenerator._vis reads both features unconditionally
        # (grit_tpu/models/cap_generator.py:326-334) and its detector leaves the
        # missing one out, so its captioner fails with a KeyError without either
        raise NotImplementedError(
            "the captioner needs both grid and region features (use_gri_feat and "
            "use_reg_feat): the JAX package has no working captioner without either")
    device = _device(device, "build_captioner")
    with device:
        model = GRITCaptioner(
            _detector(config),
            GridFeatureNetwork(m.grid_net.n_layers, d_in=m.grid_feat_dim,
                               d_model=m.d_model, n_heads=m.n_heads, dropout=m.dropout),
            CaptionGenerator(m.vocab_size, m.max_len, m.cap_generator.n_layers, m.pad_idx,
                             d_model=m.d_model, n_heads=m.n_heads, dropout=m.dropout,
                             replicate_alpha_bug=bool(m.get("replicate_alpha_bug", True)),
                             decoder_name=m.cap_generator.decoder_name))
    if seed is not None:
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return to_compute_dtype(model, dtype, master_f32=train).train(train)
