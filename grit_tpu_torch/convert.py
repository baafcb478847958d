"""Weights between the reference's torch checkpoints, the port and grit_tpu.

The port's modules carry the reference's torch parameter names, so a
released ``.pth`` loads with ``load_state_dict(strict=True)`` once the keys
that the model recomputes or never uses are dropped
(``load_reference_checkpoint``).  ``params_to_state_dict`` is the inverse of
``grit_tpu/convert.py::translate``: it maps a flax params tree of numpy
arrays (the JAX package's parameters) to the port's state_dict.
``state_dict_to_params`` goes the other way, for a state_dict or a dict of
gradients by parameter name, so that gradients and updated parameters
compare leaf by leaf with the JAX package's trees.  ``decode_tail_weights``
gives a decoder layer's 24 decode-tail weights, and ``adam_state_to_trees`` /
``adam_state_from_trees`` carry the optimizer's moments, in the JAX package's
layouts as numpy.
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
_EMBEDDINGS = ("word_emb", "pos_emb", "query_embed", "od_cls_embed")


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


def _flax_token(mods: list[str]) -> list[str]:
    """Module path of the port -> module path of the flax tree."""
    out, i = [], 0
    while i < len(mods):
        tok = mods[i]
        nxt = mods[i + 1] if i + 1 < len(mods) else None
        if tok == "input_proj":          # input_proj.N.{0,1} -> input_proj_N_{conv,norm}
            out.append(f"input_proj_{nxt}_{'conv' if mods[i + 2] == '0' else 'norm'}")
            i += 3
        elif tok == "patch_embed":       # patch_embed.{proj,norm} -> patch_embed_{proj,norm}
            out.append(f"patch_embed_{nxt}")
            i += 2
        elif nxt is not None and nxt.isdigit():
            out.append(f"{tok}_{nxt}")
            i += 2
        else:
            out.append(tok)
            i += 1
    return out


def state_dict_to_params(state_dict: dict) -> dict:
    """Port state_dict, or gradients by parameter name (numpy or tensor
    values) -> flax params tree of numpy arrays; the inverse of
    ``params_to_state_dict``."""
    params: dict = {}
    for key, value in state_dict.items():
        value = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        *mods, leaf = key.split(".")
        if leaf == "weight" and mods[-1] in _EMBEDDINGS:
            mods, leaf = mods[:-1], mods[-1]
        elif leaf == "weight" and value.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            value = value.T if value.ndim == 2 else value.transpose(2, 3, 1, 0)
            leaf = "kernel"
        node = params
        for tok in _flax_token(mods):
            node = node.setdefault(tok, {})
        node[leaf] = np.ascontiguousarray(value)
    return params


def load_reference_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference caption (``state_dict`` key) or detector (``model`` key)
    checkpoint -> a state_dict for the port's ``load_state_dict(strict=True)``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        ckpt = ckpt.get("state_dict", ckpt.get("model", ckpt))
    return {k: v for k, v in ckpt.items()
            if torch.is_tensor(v) and not any(re.search(p, k) for p in _SKIP_PATTERNS)}


def decode_tail_weights(layer) -> tuple[np.ndarray, ...]:
    """A port ``ParallelAttentionLayer``'s decode-tail weights as the numpy
    24-tuple of ``grit_tpu.ops.decode_layer`` (its ``_ref`` order, matrices
    ``[in, out]``)."""
    return tuple(np.ascontiguousarray(w.detach().float().cpu().numpy())
                 for w in layer.tail_weights(torch.float32))


def adam_state_to_trees(model, optimizer) -> tuple[dict, dict, int]:
    """The port optimizer's Adam state -> (mu tree, nu tree, step) in the
    flax params layout of ``state_dict_to_params``; parameters without state
    (frozen, or never stepped) get zeros, as optax initialises them."""
    mu, nu, steps = {}, {}, set()
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        mu[name] = st["exp_avg"] if st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(p)
        if st:
            steps.add(int(st["step"]))
    if len(steps) > 1:
        raise ValueError(f"parameters disagree on the step count: {sorted(steps)}")
    return state_dict_to_params(mu), state_dict_to_params(nu), steps.pop() if steps else 0


@torch.no_grad()
def adam_state_from_trees(model, optimizer, mu: dict, nu: dict, step: int) -> None:
    """Load flax-layout moment trees (numpy leaves, e.g. optax's
    ``ScaleByAdamState.mu`` / ``.nu`` and ``count``) into the port optimizer,
    for every parameter it holds."""
    mus, nus = params_to_state_dict(mu), params_to_state_dict(nu)
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        if id(p) in held:
            optimizer.state[p] = {
                "step": int(step),
                # copies: the trees may be views of another optimizer's state
                "exp_avg": torch.tensor(mus[name], dtype=p.dtype, device=p.device),
                "exp_avg_sq": torch.tensor(nus[name], dtype=p.dtype, device=p.device)}
