"""The program's configuration for a cell: the port's own default config
trees with the cell's configuration file's ``port_overrides`` applied, and
the compute types by name."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def caption_config(cfg: dict):
    from grit_tpu_torch.config import default_caption_config

    return default_caption_config().apply_overrides(cfg["port_overrides"], warn_unknown=False)


def detection_config(cfg: dict):
    from grit_tpu_torch.config import default_detection_config

    return default_detection_config().apply_overrides(cfg["port_overrides"], warn_unknown=False)
