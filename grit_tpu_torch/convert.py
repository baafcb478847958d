"""Weights between the reference's torch checkpoints, the port and grit_tpu.

The port's modules carry the reference's torch parameter names, so a
released ``.pth`` loads with ``load_state_dict(strict=True)`` once the keys
that the model recomputes or never uses are dropped
(``load_reference_checkpoint``).  ``params_to_state_dict`` is the inverse of
``grit_tpu/convert.py::translate``: it maps a flax params tree of numpy
arrays (the JAX package's parameters) to the port's state_dict.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# reference keys the port does not hold (as grit_tpu.convert._SKIP_PATTERNS):
# recomputed buffers, dead PatchMerging/out-norm modules, beam-state buffers
_SKIP_PATTERNS = [
    r"relative_position_index$",
    r"\.downsample\.expansion\.",
    r"\.downsample\.norm2\.",
    r"backbone\.norm[0-9]\.",
    r"\.running_keys$", r"\.running_values$",
    r"running_mask_x$", r"running_seq$",
    r"gri_feat$", r"gri_mask$", r"reg_feat$", r"reg_mask$",
]

_INDEXED = re.compile(r"(class_embed|bbox_embed|decoder_layers|blocks|layers)_(\d+)")
_INPUT_PROJ = re.compile(r"input_proj_(\d+)_(conv|norm)")
_EMBEDDINGS = ("word_emb", "pos_emb", "query_embed")


def _torch_token(tok: str) -> str:
    m = _INPUT_PROJ.fullmatch(tok)
    if m:
        return f"input_proj.{m.group(1)}.{0 if m.group(2) == 'conv' else 1}"
    if tok in ("patch_embed_proj", "patch_embed_norm"):
        return tok.replace("_proj", ".proj").replace("_norm", ".norm")
    m = _INDEXED.fullmatch(tok)
    return f"{m.group(1)}.{m.group(2)}" if m else tok


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def params_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """flax params tree (numpy leaves) -> port state_dict (numpy values).

    Dense kernels [in, out] transpose back to Linear [out, in], conv HWIO to
    OIHW, ``scale`` becomes ``weight``, ``name_N`` becomes ``name.N``."""
    out = {}
    for path, value in _flatten(params):
        *mods, leaf = path
        value = np.asarray(value)
        if leaf == "kernel":
            value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf in _EMBEDDINGS:
            mods, leaf = mods + [leaf], "weight"
        key = ".".join([_torch_token(t) for t in mods] + [leaf])
        out[key] = np.ascontiguousarray(value)
    return out


def load_reference_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference caption (``state_dict`` key) or detector (``model`` key)
    checkpoint -> a state_dict for the port's ``load_state_dict(strict=True)``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        ckpt = ckpt.get("state_dict", ckpt.get("model", ckpt))
    return {k: v for k, v in ckpt.items()
            if torch.is_tensor(v) and not any(re.search(p, k) for p in _SKIP_PATTERNS)}
