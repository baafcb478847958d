"""GRIT's visual stack with a latent-attention, mixture-of-experts language
model as its caption decoder (``model.cap_generator.decoder_name =
"mla_moe"``; the language model's keys under ``model.language_model``,
``config.language_model_config``).

The detector and the grid network are GRIT's, as in ``GRITCaptioner``; a
projector (``lm_decoder.VisualProjector``) maps the region and grid features
into the language model's width, and the language model
(``lm_decoder.LanguageModel``) reads them as the prefix of its sequence:

  slots 0 .. R-1        the R region tokens (150)
  slots R .. R+G-1      the G grid slots (GRIT's stride-64 grid map: 60 in
                        the 384x640 bucket; a padded slot is never attended)
  slot  R+G             BOS
  slot  R+G+1+j         the j-th generated word

Each slot's RoPE position is its index.  The interface is the one
``engine.evaluator.make_caption_generator`` drives:

- ``precompute_vis_kv`` (span ``grit.lm_prefill``): the projector and the
  prefill of the prefix and BOS, un-absorbed -> each layer's latents [B, P,
  kv_lora_rank + rope] per image, the key mask, and the log-probs of the
  first word;
- ``init_cache``: each layer's per-beam latents of the generated words;
- ``decode_step``: step 0 returns the prefill's log-probs, each image's row
  repeated over its beams; step t >= 1 runs word t-1 through every layer,
  absorbed, against the image's prefix (beams folded) and the beam's own
  latents, writing its latent at slot t-1.

``forward(images, seq)`` scores captions by teacher forcing over the prefix
(``seq`` starts with BOS), the full causal pass the decode path is checked
against.  The model is built for inference (``build_lm_captioner``).
"""

from __future__ import annotations

import torch
from torch import nn

from grit_tpu_torch.models.captioner import (GRITCaptioner, _detector, _device, init_weights,
                                             to_compute_dtype)
from grit_tpu_torch.models.grid_net import GridFeatureNetwork
from grit_tpu_torch.models.lm_decoder import LanguageModel, VisualProjector, rope_matrix
from grit_tpu_torch.utils.misc import trace_annotation


class LMCaptioner(GRITCaptioner):
    def __init__(self, detector, grid_net: GridFeatureNetwork, projector: VisualProjector,
                 language_model: LanguageModel, bos_idx: int):
        nn.Module.__init__(self)
        self.detector = detector
        self.grid_net = grid_net
        self.projector = projector
        self.language_model = language_model
        self.bos_idx = bos_idx

    def _feature_place(self):
        lm = self.language_model
        return lm.embed_tokens.weight.device, lm._dtype()

    def _sequence(self, vis: dict, ids: torch.Tensor):
        """The prefix tokens, then the embedded ``ids`` -> (x [B, P + L, D]
        f32, key mask [B, P + L])."""
        tokens, mask = self.projector(vis)
        x = torch.cat([tokens.float(), self.language_model.embed_tokens(ids).float()], 1)
        return x, torch.cat([mask, torch.zeros_like(ids, dtype=torch.bool)], 1)

    def forward(self, images, seq: torch.Tensor) -> torch.Tensor:
        """Teacher forcing: int captions [B, L] (BOS first) -> log-probs [B,
        L, V] of the next word at each of their positions."""
        x, mask = self._sequence(self.compute_vis(images), seq)
        h, _ = self.language_model(x, mask)
        return self.language_model.log_probs(h[:, -seq.shape[1]:])

    def precompute_vis_kv(self, vis_inputs: dict) -> dict:
        with trace_annotation("grit.lm_prefill"):
            b = vis_inputs["reg_feat"].shape[0]
            bos = torch.full((b, 1), self.bos_idx, dtype=torch.long,
                             device=vis_inputs["reg_feat"].device)
            x, mask = self._sequence(vis_inputs, bos)
            h, latents = self.language_model(x, mask)
            return {"latents": latents, "mask": mask,
                    "first": self.language_model.log_probs(h[:, -1])}

    def init_cache(self, batch: int, t_max: int) -> dict:
        lm = self.language_model
        a = lm.layers[0].self_attn
        w = lm.embed_tokens.weight

        def zeros():
            return torch.zeros((batch, t_max, a.rank + a.rope), dtype=lm._dtype(),
                               device=w.device)

        return {"layers": [zeros() for _ in lm.layers]}

    def decode_step(self, token, t: int, vis_inputs: dict, cache: dict, *, vis_kv=None,
                    vis_fold: int = 1):
        """token int [B * fold, 1] -> (log-probs [B * fold, V], cache);
        ``vis_kv`` is ``precompute_vis_kv``'s output (per image)."""
        if vis_kv is None:
            vis_kv = self.precompute_vis_kv(vis_inputs)
        if t == 0:
            return vis_kv["first"].repeat_interleave(vis_fold, 0), cache
        lm = self.language_model
        prefix_mask = vis_kv["mask"]
        pos = torch.tensor(prefix_mask.shape[1] - 1 + t, device=token.device)
        rot = rope_matrix(*lm.rope(pos))
        x = lm.embed_tokens(token[:, 0]).float()
        for layer, prefix, layer_cache in zip(lm.layers, vis_kv["latents"], cache["layers"]):
            x = layer.decode(x, rot, prefix, prefix_mask, layer_cache, t - 1, vis_fold)
        return lm.log_probs(x), cache


def build_lm_captioner(config, lm_cfg, *, device=None, dtype: torch.dtype = torch.float32,
                       seed: int | None = 0, train: bool = False) -> LMCaptioner:
    """The captioner of ``config`` with the language model of ``lm_cfg``, in
    ``eval()``, its products' weights in ``dtype``.  The language model is
    laid out on the meta device and given storage in its final types only
    (a 16 B-parameter model never exists in f32); ``seed`` None leaves its
    storage unset for a caller that loads weights."""
    if train:
        raise NotImplementedError("the mla_moe decoder is built for inference only")
    m = config.model
    device = _device(device, "build_captioner")
    with device:
        detector = _detector(config)
        grid_net = GridFeatureNetwork(m.grid_net.n_layers, d_in=m.grid_feat_dim,
                                      d_model=m.d_model, n_heads=m.n_heads, dropout=m.dropout)
        projector = VisualProjector(m.d_model, lm_cfg.hidden_size)
    with torch.device("meta"):
        lm = LanguageModel(lm_cfg)
    lm = to_compute_dtype(lm, dtype).to_empty(device=device)
    model = LMCaptioner(detector, grid_net, projector, lm, int(m.bos_idx))
    if seed is not None:
        init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return to_compute_dtype(model, dtype).eval()
