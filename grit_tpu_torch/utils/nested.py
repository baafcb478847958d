"""Padded image batches with validity masks (reference engine/utils.py:250-295).

Images are padded to a fixed bucket (a multiple of 64, so every Swin stage
divides evenly) in NHWC layout; ``mask`` is True on padded pixels.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

#: ImageNet normalization constants (reference datasets/caption/transforms/__init__.py:6-7).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ImageBatch(NamedTuple):
    """images: uint8 [B, H, W, 3] raw RGB or float [B, H, W, 3] normalized;
    mask: bool [B, H, W], True on padding."""

    images: torch.Tensor
    mask: torch.Tensor

    def to(self, device) -> "ImageBatch":
        return ImageBatch(self.images.to(device, non_blocking=True),
                          self.mask.to(device, non_blocking=True))


def device_normalize(batch: ImageBatch) -> ImageBatch:
    """``(u8/255 - mean)/std`` in f32 with padded pixels forced to 0.0 (the
    reference normalizes before zero padding); float input passes through."""
    if batch.images.dtype != torch.uint8:
        return batch
    dev = batch.images.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    x = (batch.images.float() / 255.0 - mean) / std
    return ImageBatch(x.masked_fill(batch.mask[..., None], 0.0), batch.mask)


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def batch_images(images: Sequence[np.ndarray], bucket_hw: tuple[int, int] | None = None,
                 pad_multiple: int = 64) -> ImageBatch:
    """Pad HWC images to one static shape with a pad mask (CPU tensors)."""
    if bucket_hw is None:
        h = max(im.shape[0] for im in images)
        w = max(im.shape[1] for im in images)
        bucket_hw = (round_up(h, pad_multiple), round_up(w, pad_multiple))
    bh, bw = bucket_hw
    dtype = images[0].dtype if len(images) else np.float32
    batch = np.zeros((len(images), bh, bw, 3), dtype=dtype)
    mask = np.ones((len(images), bh, bw), dtype=bool)
    for i, im in enumerate(images):
        h, w = im.shape[0], im.shape[1]
        if h > bh or w > bw:
            raise ValueError(f"image {im.shape} exceeds bucket {bucket_hw}")
        batch[i, :h, :w] = im
        mask[i, :h, :w] = False
    return ImageBatch(torch.from_numpy(batch), torch.from_numpy(mask))


def downsample_mask(mask: torch.Tensor, stride: int) -> torch.Tensor:
    """[B, H, W] pad mask -> [B, H/s, W/s] (nearest, top-left of each cell)."""
    return mask[:, ::stride, ::stride]


def to_device(tree, device):
    """A loader batch's leaves on ``device``: ``ImageBatch``es and tensors
    moved, numpy arrays converted and moved (integers as int64), containers
    walked, anything else (caption strings, ids) left as it is."""
    if isinstance(tree, ImageBatch):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
        if not tree.is_floating_point() and tree.dtype not in (torch.bool, torch.uint8):
            tree = tree.long()
    if torch.is_tensor(tree):
        return tree.to(device, non_blocking=True)
    return tree


def pad_leading(tree, size: int, int_fill: int = 1, int_first: int | None = None):
    """Pad every array of a batch along its leading axis up to ``size`` rows
    (grit_tpu.parallel.mesh.pad_to_multiple's conventions): images, features
    and masks with zeros (a zero image with an all-valid mask is numerically
    safe, and its outputs carry no weight downstream); integer leaves other
    than uint8 images with ``int_fill`` (the ``<pad>`` id), their first column
    with ``int_first`` where given (the ``<bos>`` id: an all-pad caption row
    would mask every self-attention key of its queries)."""
    if isinstance(tree, ImageBatch):
        return ImageBatch(*(pad_leading(t, size) for t in tree))
    if isinstance(tree, dict):
        return {k: pad_leading(v, size, int_fill, int_first) for k, v in tree.items()}
    is_np = isinstance(tree, np.ndarray)
    if not (is_np or torch.is_tensor(tree)) or tree.ndim == 0 or tree.shape[0] >= size:
        return tree
    arr = tree if is_np else tree.cpu().numpy()
    rem = size - arr.shape[0]
    if np.issubdtype(arr.dtype, np.integer) and arr.dtype != np.uint8:
        block = np.full((rem,) + arr.shape[1:], int_fill, dtype=arr.dtype)
        if int_first is not None and arr.ndim >= 2 and arr.shape[1] > 0:
            block[:, 0] = int_first
    else:
        block = np.zeros((rem,) + arr.shape[1:], dtype=arr.dtype)
    out = np.concatenate([arr, block], axis=0)
    return out if is_np else torch.from_numpy(out)


def first_rows(tree, n: int):
    """The first ``n`` rows of every array of a batch (``ImageBatch``es,
    dicts, arrays and tensors; lists cut too)."""
    if isinstance(tree, ImageBatch):
        return ImageBatch(*(t[:n] for t in tree))
    if isinstance(tree, dict):
        return {k: first_rows(v, n) for k, v in tree.items()}
    if isinstance(tree, list) or getattr(tree, "ndim", 0) > 0:
        return tree[:n]
    return tree
