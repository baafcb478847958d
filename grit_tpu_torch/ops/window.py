"""Window helpers for shifted-window (Swin) attention.

Semantics match the reference (models/common/swin_model.py:76-105 window
partition/reverse, :423-441 shifted-window attention mask, :134-145
relative-position index).  The CUDA block kernel folds partition, reverse
and the shift into its addresses; these are the plain versions' helpers.
"""

from __future__ import annotations

import numpy as np
import torch


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nH * nW, window*window, C] (H, W divisible by window)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """Inverse of ``window_partition``: [B*nW, window*window, C] -> [B, H, W, C]."""
    nwin = (h // window) * (w // window)
    b = windows.shape[0] // nwin
    c = windows.shape[-1]
    x = windows.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_index(window: int, device=None) -> torch.Tensor:
    """[N, N] long index into the (2w-1)^2 relative-bias table, N = window^2."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (window - 1)
    idx = rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def relative_position_gather(window: int, device=None) -> torch.Tensor:
    """[(2w-1)^2, N] long, N = window^2: for each row r of the relative-bias
    table, the flat positions i N + j of the [N, N] bias that read row r
    (``relative_position_index`` is r there), in increasing order, padded
    with N^2.  With a zero appended to a flattened [.., N^2] gradient, a
    gather by this index and a sum over its last axis scatter the gradient
    into the table in a fixed order (no atomics)."""
    n = window * window
    idx = relative_position_index(window).numpy().reshape(-1)
    rows = (2 * window - 1) ** 2
    out = np.full((rows, n), n * n, np.int64)
    for r in range(rows):
        pos = np.flatnonzero(idx == r)
        out[r, :len(pos)] = pos
    return torch.as_tensor(out, device=device)


def shifted_window_mask(hp: int, wp: int, window: int, shift: int,
                        device=None) -> torch.Tensor:
    """Additive mask [nW, window^2, window^2] for SW-MSA on the padded grid:
    0 within a region, -100 across regions (the reference's constant)."""
    img = np.zeros((hp, wp), np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(hp // window, window, wp // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = np.where(img[:, None, :] != img[:, :, None], -100.0, 0.0)
    return torch.as_tensor(mask, dtype=torch.float32, device=device)
