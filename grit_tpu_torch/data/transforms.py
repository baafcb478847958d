"""Host-side image transforms (PIL + numpy; no torch/torchvision).

Parity: reference datasets/caption/transforms/*.

- resize families ``normal`` / ``minmax`` / ``maxwh`` (transforms/utils.py:4-42;
  maxwh = fit inside (H, W) keeping aspect ratio, bicubic);
- RandAugment: 4 random ops per image from the reference's 11-op list with
  the same value ranges (transforms/randaug.py:74-103);
- ImageNet mean/std normalization (transforms/__init__.py:6-7).

Output is float32 HWC (channels last); batching + pad-mask
creation happens in ``grit_tpu_torch.utils.nested.batch_images``.
"""

from __future__ import annotations

import random
from typing import Callable

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
STD = np.asarray([0.229, 0.224, 0.225], np.float32)


# -- resize families -----------------------------------------------------------

def maxwh_resize(img: Image.Image, size) -> Image.Image:
    max_h, max_w = size
    w, h = img.size
    scale = min(max_w / w, max_h / h)
    return img.resize((int(w * scale), int(h * scale)), resample=Image.BICUBIC)


def minmax_resize(img: Image.Image, size) -> Image.Image:
    lo, hi = size
    w, h = img.size
    scale = lo / min(w, h)
    if h < w:
        newh, neww = lo, scale * w
    else:
        newh, neww = scale * h, lo
    if max(newh, neww) > hi:
        s = hi / max(newh, neww)
        newh, neww = newh * s, neww * s
    newh, neww = int(newh + 0.5) // 32 * 32, int(neww + 0.5) // 32 * 32
    return img.resize((neww, newh), resample=Image.BICUBIC)


def normal_resize(img: Image.Image, size) -> Image.Image:
    h, w = size
    return img.resize((w, h), resample=Image.BICUBIC)


RESIZE = {"normal": normal_resize, "minmax": minmax_resize, "maxwh": maxwh_resize}


# -- RandAugment ---------------------------------------------------------------

def _shear_x(img, v):
    v = -v if random.random() > 0.5 else v
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0))


def _shear_y(img, v):
    v = -v if random.random() > 0.5 else v
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0))


def _translate_x(img, v):
    v = -v if random.random() > 0.5 else v
    return img.transform(img.size, Image.AFFINE, (1, 0, v, 0, 1, 0))


def _translate_y(img, v):
    v = -v if random.random() > 0.5 else v
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v))


def _rotate(img, v):
    v = -v if random.random() > 0.5 else v
    return img.rotate(v)


AUGMENT_LIST: list[tuple[Callable, float, float]] = [
    (lambda img, v: img, 0, 100),                                     # Identity
    (lambda img, v: ImageOps.autocontrast(img), 0, 100),              # AutoContrast
    (_rotate, 0, 8),
    (lambda img, v: ImageEnhance.Color(img).enhance(v), 0.5, 1.5),
    (lambda img, v: ImageEnhance.Contrast(img).enhance(v), 0.5, 1.5),
    (lambda img, v: ImageEnhance.Brightness(img).enhance(v), 0.5, 1.5),
    (lambda img, v: ImageEnhance.Sharpness(img).enhance(v), 0.5, 1.5),
    (_shear_x, 0.0, 0.12),
    (_shear_y, 0.0, 0.12),
    (_translate_x, 0.0, 80),
    (_translate_y, 0.0, 80),
]


class RandAugment:
    def __init__(self, n_augments: int = 4):
        self.n_augments = n_augments

    def __call__(self, img: Image.Image) -> Image.Image:
        for op, lo, hi in random.choices(AUGMENT_LIST, k=self.n_augments):
            img = op(img, random.random() * (hi - lo) + lo)
        return img


# -- pipeline ------------------------------------------------------------------

def to_normalized_array(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - MEAN) / STD


def get_transform(cfg):
    """cfg: transform config node {size, resize_name, randaug[, device_norm]}
    -> {train, valid}.

    With ``device_norm`` (the production config default) the pipeline emits
    raw uint8 RGB and the ImageNet normalize runs ON DEVICE
    (utils.nested.device_normalize, dtype-gated in the captioner) — 4x less
    host->device transfer per batch and one less f32 pass on the host.
    Absent the key (plain namespaces, e.g. the parity tools) the historical
    host-normalized float32 output is kept.
    """
    resize = RESIZE[cfg.resize_name]
    size = tuple(cfg.size)
    aug = RandAugment() if cfg.randaug else None
    if hasattr(cfg, "get"):
        dn = cfg.get("device_norm", False)
    else:
        dn = getattr(cfg, "device_norm", False)
    to_array = (lambda img: np.asarray(img, np.uint8)) if dn else to_normalized_array

    def train(img: Image.Image) -> np.ndarray:
        img = resize(img.convert("RGB"), size)
        if aug is not None:
            img = aug(img)
        return to_array(img)

    def valid(img: Image.Image) -> np.ndarray:
        return to_array(resize(img.convert("RGB"), size))

    return {"train": train, "valid": valid}
