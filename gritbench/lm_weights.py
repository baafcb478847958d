"""The benchmark's weights for a captioner whose decoder is a language model
(``model.cap_generator.decoder_name="mla_moe"``), made from ``--seed``.

The visual stack and the projector (every parameter outside
``language_model.``) take ``gritbench/weights.py``'s one flat draw, as the
GRIT captioner's do.  The language model's parameters are drawn one at a
time, each from a generator of its own seeded from ``--seed`` and its index,
so that any of them can be drawn again alone, on the device it is needed on:

- matrices: normal with std 0.02 (DeepSeek-V3's ``initializer_range``);
- norm scales: 1 + 0.1 u, u uniform in [-1, 1);
- the router's correction bias: 0.05 u (it moves some choices and weights
  none);

each then rounded to bfloat16, the type the model is published in: the
weights are bf16 values, which the program stores as they are and the
reference reads in float32.  ``LazyParams`` gives the reference the
language model's parameters a layer at a time.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import torch

from gritbench.weights import make_weights

LM = "language_model."
_LAYER = re.compile(r"^(language_model\.layers\.\d+\.)")


def _seed(seed: int, index: int) -> int:
    return (int(seed) * 1000003 + 7919 * index + 1) % 2 ** 63


def lm_param(name: str, shape, seed: int, index: int, device) -> torch.Tensor:
    """The language model's ``index``-th parameter, float32 holding bf16
    values."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, index))
    if len(shape) > 1:
        t = torch.randn(shape, generator=gen, device=device) * 0.02
    else:
        u = torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
        t = 0.05 * u if name.endswith("e_score_correction_bias") else 1.0 + 0.1 * u
    return t.to(torch.bfloat16).float()


def split(named_shapes):
    """-> (the visual stack's and projector's (name, shape) list, the
    language model's (name, shape, index) list)."""
    vis = [(n, s) for n, s in named_shapes if not n.startswith(LM)]
    lm = [(n, s, i) for i, (n, s) in enumerate(x for x in named_shapes if x[0].startswith(LM))]
    return vis, lm


@torch.no_grad()
def load(model, named_shapes, seed: int, device, det: dict) -> None:
    """Copy the weights of ``seed`` into ``model``'s parameters (each in its
    own storage type: the copy rounds the products' weights to the compute
    type), one language-model parameter at a time."""
    vis, lm = split(named_shapes)
    params = dict(model.named_parameters())
    for name, t in make_weights(vis, seed, device, det=det).items():
        params[name].copy_(t)
    for name, shape, i in lm:
        params[name].copy_(lm_param(name, shape, seed, i, device))


class LazyParams(Mapping):
    """The weights of ``seed`` by name: the visual ones drawn at once, the
    language model's drawn when first read and kept while the reads stay in
    one layer (the embedding, final norm and head are kept throughout)."""

    def __init__(self, named_shapes, seed: int, device, det: dict):
        vis, lm = split(named_shapes)
        self.seed, self.device = seed, device
        self.vis = make_weights(vis, seed, device, det=det)
        self.lm = {n: (s, i) for n, s, i in lm}
        self.kept: dict[str, torch.Tensor] = {}
        self.layer: dict[str, torch.Tensor] = {}
        self.layer_name = None

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self.vis:
            return self.vis[name]
        m = _LAYER.match(name)
        if m is None:
            if name not in self.kept:
                shape, i = self.lm[name]
                self.kept[name] = lm_param(name, shape, self.seed, i, self.device)
            return self.kept[name]
        if m.group(1) != self.layer_name:
            self.layer, self.layer_name = {}, m.group(1)
        if name not in self.layer:
            shape, i = self.lm[name]
            self.layer[name] = lm_param(name, shape, self.seed, i, self.device)
        return self.layer[name]

    def __iter__(self):
        return iter([*self.vis, *self.lm])

    def __len__(self) -> int:
        return len(self.vis) + len(self.lm)
