"""Sinusoidal position table (reference models/common/pos_embed.py:13-31):
interleaved sin at even channels, cos at odd, row ``padding_idx`` zeroed."""

from __future__ import annotations

import numpy as np
import torch


def sinusoid_encoding_table(max_len: int, d_model: int,
                            padding_idx: int | None = None) -> torch.Tensor:
    """[max_len, d_model]: out[p, 2i] = sin(p / 10000^(2i/d)), out[p, 2i+1] = cos."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    dim = np.arange(d_model // 2, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    out = np.zeros((max_len, d_model), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    if padding_idx is not None:
        out[padding_idx] = 0.0
    return torch.from_numpy(out)
