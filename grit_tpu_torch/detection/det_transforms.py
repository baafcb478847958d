"""DETR-style paired (image, target) transforms for detection training.

Parity: reference datasets/detection/transforms.py:107-238 (crop/hflip/
resize with box+area updates), :370-388 (Normalize -> cxcywh in [0,1]),
multi-scale RandomSelect policy and the make_transforms presets (:409-465).

Pure PIL + numpy; targets are dicts {boxes [N,4] xyxy pixels, labels [N],
area [N], (attributes)}.  Output images are float32 HWC ImageNet-normalized.
"""

from __future__ import annotations

import random
import threading

import numpy as np
from PIL import Image

from grit_tpu_torch.data.transforms import MEAN, STD

DEFAULT_SCALES = [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]

_tls = threading.local()


def seed_item_rng(seed: int) -> None:
    """Install a thread-local RNG for this thread's transform calls.

    The production loader (grit_tpu_torch/detection/loader.py) transforms batch
    items on a thread pool; drawing from the global ``random`` there would
    make augmentation depend on thread scheduling.  Seeding per item with
    (seed, epoch, dataset index) makes every augmentation a pure function of
    those — deterministic across worker counts AND across kill-and-resume.
    Without a call to this (e.g. direct transform use in tests), transforms
    fall back to the global ``random`` module, reference-style.
    """
    _tls.rng = random.Random(seed)


def _rng():
    return getattr(_tls, "rng", None) or random


def hflip(img: Image.Image, target: dict):
    img = img.transpose(Image.FLIP_LEFT_RIGHT)
    w = img.size[0]
    t = dict(target)
    if len(t.get("boxes", [])):
        b = t["boxes"].copy()
        b[:, [0, 2]] = w - t["boxes"][:, [2, 0]]
        t["boxes"] = b
    return img, t


def resize(img: Image.Image, target: dict, size: int, max_size: int | None = None):
    """Shortest side -> size, cap longest side at max_size (transforms.py:148-212)."""
    w, h = img.size
    short, long = min(w, h), max(w, h)
    scale = size / short
    if max_size is not None and long * scale > max_size:
        scale = max_size / long
    nw, nh = int(round(w * scale)), int(round(h * scale))
    img = img.resize((nw, nh), resample=Image.BILINEAR)
    t = dict(target)
    sx, sy = nw / w, nh / h
    if len(t.get("boxes", [])):
        b = t["boxes"] * np.asarray([sx, sy, sx, sy], np.float32)
        t["boxes"] = b
    if "area" in t and len(t["area"]):
        t["area"] = t["area"] * (sx * sy)
    return img, t


def crop(img: Image.Image, target: dict, region):
    """region = (top, left, h, w); drops boxes that collapse (transforms.py:107-146)."""
    top, left, h, w = region
    img = img.crop((left, top, left + w, top + h))
    t = dict(target)
    if len(t.get("boxes", [])):
        b = t["boxes"] - np.asarray([left, top, left, top], np.float32)
        b[:, 0::2] = b[:, 0::2].clip(0, w)
        b[:, 1::2] = b[:, 1::2].clip(0, h)
        keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        t["boxes"] = b[keep]
        for key in ("labels", "area", "attributes"):
            if key in t and len(t[key]):
                t[key] = t[key][keep]
        if "area" in t and len(t["area"]):
            t["area"] = (b[keep, 2] - b[keep, 0]) * (b[keep, 3] - b[keep, 1])
    return img, t


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, target):
        if _rng().random() < self.p:
            return hflip(img, target)
        return img, target


class RandomResize:
    def __init__(self, sizes, max_size=None):
        self.sizes = sizes
        self.max_size = max_size

    def __call__(self, img, target):
        return resize(img, target, _rng().choice(self.sizes), self.max_size)


class RandomSizeCrop:
    def __init__(self, min_size: int, max_size: int):
        self.min_size = min_size
        self.max_size = max_size

    def __call__(self, img, target):
        w = _rng().randint(self.min_size, min(img.width, self.max_size))
        h = _rng().randint(self.min_size, min(img.height, self.max_size))
        top = _rng().randint(0, img.height - h)
        left = _rng().randint(0, img.width - w)
        return crop(img, target, (top, left, h, w))


class RandomSelect:
    """Pick transform A with prob p else B (the multi-scale policy switch)."""

    def __init__(self, a, b, p=0.5):
        self.a, self.b, self.p = a, b, p

    def __call__(self, img, target):
        return (self.a if _rng().random() < self.p else self.b)(img, target)


class Compose:
    def __init__(self, ts):
        self.ts = ts

    def __call__(self, img, target):
        for t in self.ts:
            img, target = t(img, target)
        return img, target


class Normalize:
    """Boxes -> normalized cxcywh (transforms.py:370-388); image -> array.

    With ``device_norm`` (the production default) the image stays raw
    uint8 RGB and the ImageNet normalize runs ON DEVICE at the detector
    entry (utils.nested.device_normalize) — 4x less host->device transfer
    per det batch (a b4 832x1216 f32 batch is 48.6 MB).  ``False`` keeps
    the historical host-normalized float32 output.
    """

    def __init__(self, device_norm: bool = True):
        self.device_norm = device_norm

    def __call__(self, img: Image.Image, target: dict):
        if self.device_norm:
            arr = np.asarray(img.convert("RGB"), np.uint8)
        else:
            arr = (np.asarray(img.convert("RGB"), np.float32) / 255.0 - MEAN) / STD
        h, w = arr.shape[:2]
        t = dict(target)
        if len(t.get("boxes", [])):
            b = t["boxes"].astype(np.float32)
            cxcywh = np.stack([
                (b[:, 0] + b[:, 2]) / 2 / w,
                (b[:, 1] + b[:, 3]) / 2 / h,
                (b[:, 2] - b[:, 0]) / w,
                (b[:, 3] - b[:, 1]) / h,
            ], axis=1)
            t["boxes"] = cxcywh
        return arr, t


def make_transforms(split: str, scales=None, max_size: int = 1333,
                    device_norm: bool = True):
    """Presets mirroring transforms.py:409-465."""
    scales = scales or DEFAULT_SCALES
    if split == "train":
        return Compose([
            RandomHorizontalFlip(),
            RandomSelect(
                RandomResize(scales, max_size=max_size),
                Compose([
                    RandomResize([400, 500, 600]),
                    RandomSizeCrop(384, 600),
                    RandomResize(scales, max_size=max_size),
                ]),
            ),
            Normalize(device_norm),
        ])
    return Compose([RandomResize([800], max_size=max_size),
                    Normalize(device_norm)])
