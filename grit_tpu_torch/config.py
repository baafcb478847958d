"""Config tree for grit_tpu_torch (the port's own copy of grit_tpu/config.py:
the same keys and defaults, so recipes and dotted overrides transfer).

Mirrors the reference Hydra schema (reference: configs/caption/coco_config.yaml:1-94
and configs/detection/train_config.yaml) so recipes transfer 1:1, but implemented
as a small dependency-free attribute tree:

- ``Config`` — dict-backed node with attribute access, deep merge, dotted-path
  overrides (``cfg.set("model.d_model", 768)``) and YAML round-trip.
- ``default_caption_config()`` / ``default_detection_config()`` — full default
  trees matching the reference defaults.

Environment interpolation ``${oc.env:DATA_ROOT}`` is supported for string leaves.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Iterator

_ENV_RE = re.compile(r"\$\{oc\.env:([A-Za-z_][A-Za-z0-9_]*)\}")
_MISSING = object()


def _interp(value: Any) -> Any:
    if isinstance(value, str):
        return _ENV_RE.sub(lambda m: os.environ.get(m.group(1), ""), value)
    return value


class Config:
    """A nested attribute-access config node backed by a plain dict."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = Config(v) if isinstance(v, dict) else v

    # -- attribute / item access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return _interp(self._data[name])
        except KeyError:
            raise AttributeError(f"config has no key {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = Config(value) if isinstance(value, dict) else value

    def __getitem__(self, name: str) -> Any:
        return self.__getattr__(name)

    def __setitem__(self, name: str, value: Any) -> None:
        self.__setattr__(name, value)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def get(self, name: str, default: Any = None) -> Any:
        return _interp(self._data.get(name, default))

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, _interp(v)) for k, v in self._data.items()]

    # -- dotted paths -------------------------------------------------------------
    def select(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Config) or part not in node:
                return default
            node = node[part]
        return node

    def set(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    # -- merge / io ---------------------------------------------------------------
    def merge(self, other: "Config | dict") -> "Config":
        src = other._data if isinstance(other, Config) else other
        for k, v in src.items():
            if isinstance(v, (Config, dict)) and isinstance(self._data.get(k), Config):
                self._data[k].merge(v)
            else:
                self._data[k] = Config(v) if isinstance(v, dict) else copy.deepcopy(v)
        return self

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def copy(self) -> "Config":
        return Config(self.to_dict())

    def __repr__(self) -> str:
        return "Config(" + json.dumps(self.to_dict(), default=str, indent=2) + ")"

    @staticmethod
    def from_yaml(path: str) -> "Config":
        import yaml

        with open(path) as f:
            return Config(yaml.safe_load(f))

    def to_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def apply_overrides(self, overrides: list[str], warn_unknown: bool = True) -> "Config":
        """Apply CLI-style dotted overrides, e.g. ``["model.d_model=768"]``.

        Unknown keys are applied but warned about (a typo'd override would
        otherwise silently create a dead key).  Dataset-registry groups
        (``dataset.roots.<name>`` etc. — the reference's ``od_dataset@dataset:``
        config groups, train_config.yaml:13-16) are open namespaces: new
        entries there are the intended usage, not typos.
        """
        import sys

        open_ns = ("dataset.roots.", "dataset.valid_roots.", "dataset.num_copies.",
                   "model.language_model.")
        for ov in overrides:
            path, _, raw = ov.partition("=")
            path = path.strip()
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            in_open_ns = path.startswith(open_ns)
            if warn_unknown and not in_open_ns and self.select(path, _MISSING) is _MISSING:
                print(
                    f"[config] warning: override creates new key {path!r} "
                    "(typo?)", file=sys.stderr,
                )
            self.set(path, value)
        return self


#: The language model of Kimi-VL-A3B-Instruct (moonshotai/Kimi-VL-A3B-Instruct
#: config.json), the keys that shape it: the ``mla_moe`` caption decoder's
#: defaults (``models/lm_decoder.py``).  ``initializer_range`` is the
#: DeepSeek-V3 family's (the catalog row omits it).
KIMI_VL_A3B = {
    "vocab_size": 163840, "hidden_size": 2048, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27, "num_attention_heads": 16,
    "n_shared_experts": 2, "n_routed_experts": 64, "routed_scaling_factor": 2.446,
    "kv_lora_rank": 512, "q_lora_rank": None, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "qk_nope_head_dim": 128, "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
    "num_experts_per_tok": 6, "moe_layer_freq": 1, "first_k_dense_replace": 1,
    "norm_topk_prob": True, "scoring_func": "sigmoid", "rms_norm_eps": 1e-5,
    "rope_theta": 800000, "rope_scaling": None, "attention_bias": False,
    "tie_word_embeddings": False, "initializer_range": 0.02,
}


def language_model_config(model: Config) -> Config:
    """The ``mla_moe`` decoder's language model: ``KIMI_VL_A3B`` with the
    keys that ``model.language_model`` sets (the caption config's own tree
    has no such block, as grit_tpu's has none)."""
    given = model.get("language_model")
    return Config(dict(KIMI_VL_A3B, **(given.to_dict() if given is not None else {})))


def default_caption_config() -> Config:
    """Defaults matching the reference caption recipe.

    Reference: configs/caption/coco_config.yaml:1-94.
    """
    return Config({
        "exp": {
            "seed": 42,
            "name": "eval",
            "rank": 0,
            "ngpus_per_node": 8,
            "world_size": 8,
            "checkpoint": "",
            "eval": False,
            "resume": False,
        },
        "dataset": {
            "overfit": False,
            "ann_root": "${oc.env:DATA_ROOT}/annotations",
            "img_root": "${oc.env:DATA_ROOT}",
            "hdf5_path": "${oc.env:DATA_ROOT}/all_splits.h5",
            "vocab_path": "${oc.env:DATA_ROOT}/annotations/vocab.json",
            "transform_cfg": {
                "size": [384, 640],
                "resize_name": "maxwh",  # normal | minmax | maxwh
                "randaug": True,
                # ship uint8 RGB to the device and ImageNet-normalize there
                # (4x less host->device transfer; bit-equal semantics incl.
                # pad-zero — see utils/nested.py::device_normalize)
                "device_norm": True,
            },
        },
        "model": {
            "use_gri_feat": True,
            "use_reg_feat": True,
            "grid_feat_dim": 1024,
            "frozen_stages": 2,
            "beam_size": 5,
            "beam_len": 20,
            "dropout": 0.2,
            "attn_dropout": 0.2,
            "vocab_size": 10201,
            "max_len": 54,
            "pad_idx": 1,
            "bos_idx": 2,
            "eos_idx": 3,
            "d_model": 512,
            "n_heads": 8,
            # knobs outside the reference schema (kept key for key with the JAX
            # package; the port ignores msda_impl and fused_win_attn: its
            # kernels are always on)
            "compute_dtype": "float32",   # "float32" | "bfloat16"
            "backbone": "swin_base_win7_384_22k",  # see swin.BACKBONES
            "msda_impl": "",
            "fused_win_attn": "",
            "use_checkpoint": False,      # Swin activation remat
            "replicate_alpha_bug": True,  # fc_alpha1-for-alpha2 quirk (ckpt parity)
            "grid_net": {"n_memories": 1, "n_layers": 3},
            "cap_generator": {"decoder_name": "parallel", "n_layers": 3},
            "detector": {
                "checkpoint": "",
                "d_model": 512,
                "dim_feedforward": 1024,
                "num_heads": 8,
                "num_layers": 6,
                "num_levels": 4,
                "num_points": 4,
                "num_queries": 150,
                "num_classes": 1849,
                "dropout": 0.1,
                "activation": "relu",
                "return_intermediate": True,
                "with_box_refine": True,
            },
        },
        "optimizer": {
            "warmup_init_lr": 1e-5,
            "min_lr": 1e-4,
            "xe_lr": 1e-4,
            "sc_lr": 5e-6,
            "xe_backbone_lr": 1e-5,
            "sc_backbone_lr": 5e-6,
            "weight_decay": 0.01,
            "beta_1": 0.9,
            "beta_2": 0.99,
            "batch_size": 16,
            # SCST batch = batch_size // sc_batch_divisor (finetune phases).
            # 4 is the reference's V100-memory convention; 2 is the measured
            # JAX package's default (the gradient is batch-linear)
            "sc_batch_divisor": 2,
            "num_workers": 2,
            "freezing_xe_epochs": 0,
            "freezing_sc_epochs": 0,
            "finetune_xe_epochs": 10,
            "finetune_sc_epochs": 10,
            "freeze_detector": False,
            "freeze_backbone": False,
        },
    })


def default_detection_config() -> Config:
    """Defaults matching the reference detector pre-training recipe.

    Reference: configs/detection/train_config.yaml:1-87.
    """
    return Config({
        "exp": {
            "seed": 42,
            "name": "detection",
            "rank": 0,
            "ngpus_per_node": 8,
            "world_size": 64,
            "resume": False,
            "checkpoint": "",
        },
        "dataset": {
            "overfit": False,
            "roots": {},          # name -> {img_root, ann_file, ...}
            "valid_roots": {},    # name -> {img_root, ann_file} for mAP eval
            "num_copies": {},     # name -> int
            "max_size": 1333,
            "scales": [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800],
            # static-shape bucket: pad EVERY train batch to this (H, W)
            # so the whole run compiles one step (a full-size detector step
            # compiles for minutes — docs/NOTES.md).  [832, 1344] covers the
            # 800/1333 multi-scale envelope; null = reference-style
            # per-batch pad-to-max (one compile per encountered shape).
            "fixed_bucket": [832, 1344],
        },
        "model": {
            "backbone": "swin_base_win7_384_22k",
            # detector PRE-training fine-tunes the whole backbone (reference
            # detection/detector.py:118 builds Swin with the default
            # frozen_stages=-1; only CAPTION training freezes stages)
            "frozen_stages": -1,
            "use_gri_feat": False,
            "use_reg_feat": True,
            "d_model": 512,
            "num_classes": 1849,
            "with_attributes": False,
            "num_attr_classes": 400,
            "detector": {
                "d_model": 512,
                "dim_feedforward": 1024,
                "num_heads": 8,
                "num_layers": 6,
                "num_levels": 4,
                "num_points": 4,
                "num_queries": 150,
                "num_classes": 1849,
                "dropout": 0.1,
                "activation": "relu",
                "return_intermediate": True,
                "with_box_refine": True,
                "aux_loss": True,
            },
            "losses": {
                "cls_loss_coef": 2.0,
                "bbox_loss_coef": 5.0,
                "giou_loss_coef": 2.0,
                "attr_loss_coef": 1.0,
                "focal_alpha": 0.25,
                "set_cost_class": 2.0,
                "set_cost_bbox": 5.0,
                "set_cost_giou": 2.0,
                # Hungarian solver: "auto" = on-device batched LAP on an accelerator,
                # scipy host callback on CPU (docs/FLAGS.md)
                "match_impl": "auto",
            },
        },
        "optimizer": {
            # reference train_config.yaml:63-77: note lr_backbone > lr — the
            # Swin is pre-trained and fine-tunes at 2e-5 while the fresh
            # decoder/heads train at 1e-5, with attr_head on its own AdamW
            "lr": 1e-5,
            "lr_backbone": 2e-5,
            "sp_names": ["attr_head"],
            "sp_lr": 1e-4,
            "sp_lr_drop_epochs": [5],
            "weight_decay": 1e-4,
            "clip_max_norm": 0.1,
            "batch_size": 4,
            "epochs": 50,
            "num_workers": 4,
            "lr_drop_epochs": [40],
            "decay_rate": 0.1,
        },
    })
