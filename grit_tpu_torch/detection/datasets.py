"""Detection datasets: COCO / Visual Genome / Objects365 / OpenImages.

Capability parity with the reference detection data layer
(datasets/detection/base.py, coco.py, visualgenome.py, objects365.py,
openimages.py, __init__.py:16-56):

- base classes for json-annotation and LMDB-image storage with lazy txn open
  and corrupt-sample resample-on-exception (base.py:33-35, :49-61);
- CocoDetectionDataset with Karpathy-test-id exclusion (coco.py:27-33);
- VisualGenomeDataset with multi-hot attribute targets (visualgenome.py:51-62);
- Objects365 / OpenImages as json-format datasets;
- a name registry plus ``num_copies`` concatenation for multi-dataset
  training (__init__.py:43-56);
- overfit-64 truncation (base.py:37-40).

Annotations load from COCO-format json (self-parsed — no pycocotools).
Targets are numpy dicts; ``pad_targets`` produces the fixed-G padded arrays
the criterion consumes (grit_tpu_torch.detection.losses).
"""

from __future__ import annotations

import json
import os
import random
from typing import Optional

import numpy as np

OVERFIT_SIZE = 64


class DetectionDataset:
    """COCO-format json detection dataset with optional LMDB image storage."""

    def __init__(
        self,
        ann_file: str,
        img_root: str = "",
        lmdb_path: Optional[str] = None,
        exclude_image_ids: Optional[set] = None,
        with_attributes: bool = False,
        num_attr_classes: int = 400,
        overfit: bool = False,
    ):
        data = json.load(open(ann_file))
        self.images = {im["id"]: im for im in data["images"]}
        self.anns_by_image: dict = {}
        for ann in data["annotations"]:
            if ann.get("iscrowd", 0):
                continue
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        ids = [i for i in self.images if i in self.anns_by_image]
        if exclude_image_ids:
            ids = [i for i in ids if i not in exclude_image_ids]
        self.ids = sorted(ids)
        self.img_root = img_root
        self.lmdb_path = lmdb_path
        self._lmdb_env = None  # lazy (base.py:33-35)
        self.with_attributes = with_attributes
        self.num_attr_classes = num_attr_classes
        self.overfit = overfit

    def __len__(self):
        if self.overfit:
            return min(OVERFIT_SIZE, len(self.ids))
        return len(self.ids)

    def _open_image(self, info: dict):
        from io import BytesIO

        from PIL import Image

        if self.lmdb_path is not None:
            if self._lmdb_env is None:
                import lmdb

                self._lmdb_env = lmdb.open(
                    self.lmdb_path, readonly=True, lock=False, readahead=False
                )
            with self._lmdb_env.begin(write=False) as txn:
                raw = txn.get(str(info["id"]).encode())
            return Image.open(BytesIO(raw)).convert("RGB")
        return Image.open(os.path.join(self.img_root, info["file_name"])).convert("RGB")

    def _raw_item(self, idx: int):
        img_id = self.ids[idx]
        info = self.images[img_id]
        anns = self.anns_by_image.get(img_id, [])
        boxes, labels, areas, attrs = [], [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            if w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(a["category_id"])
            areas.append(a.get("area", w * h))
            if self.with_attributes:
                multi = np.zeros(self.num_attr_classes, np.float32)
                for attr_id in a.get("attribute_ids", []):
                    if 0 <= attr_id < self.num_attr_classes:
                        multi[attr_id] = 1.0
                attrs.append(multi)
        target = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "area": np.asarray(areas, np.float32),
            "image_id": img_id,
            "orig_size": np.asarray([info["height"], info["width"]], np.int32),
        }
        if self.with_attributes:
            target["attributes"] = (
                np.stack(attrs) if attrs else np.zeros((0, self.num_attr_classes), np.float32)
            )
            target["has_attr"] = True
        img = self._open_image(info)
        return img, target

    def __getitem__(self, idx: int):
        # corrupt-sample resample-on-exception (base.py:49-61)
        for _ in range(8):
            try:
                return self._raw_item(idx)
            except Exception:
                idx = random.randrange(len(self.ids))
        raise RuntimeError("too many corrupt samples")


class CocoDetectionDataset(DetectionDataset):
    """COCO objects, optionally excluding Karpathy test/val images (coco.py:27-33)."""

    def __init__(self, ann_file, img_root, karpathy_ids_file=None, **kw):
        exclude = None
        if karpathy_ids_file and os.path.exists(karpathy_ids_file):
            exclude = set(np.load(karpathy_ids_file).tolist())
        super().__init__(ann_file, img_root, exclude_image_ids=exclude, **kw)


class VisualGenomeDataset(DetectionDataset):
    def __init__(self, ann_file, img_root, **kw):
        kw.setdefault("with_attributes", True)
        super().__init__(ann_file, img_root, **kw)


class Objects365Dataset(DetectionDataset):
    pass


class OpenImagesDataset(DetectionDataset):
    pass


DATASET_REGISTRY = {
    "coco": CocoDetectionDataset,
    "vg": VisualGenomeDataset,
    "visualgenome": VisualGenomeDataset,
    "objects365": Objects365Dataset,
    "openimages": OpenImagesDataset,
}


class ConcatDataset:
    """num_copies concatenation over multiple datasets (__init__.py:43-56)."""

    def __init__(self, datasets: list, num_copies: Optional[list[int]] = None):
        num_copies = num_copies or [1] * len(datasets)
        self.parts = []
        for ds, n in zip(datasets, num_copies):
            self.parts += [ds] * n
        self.offsets = np.cumsum([0] + [len(p) for p in self.parts])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        part = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.parts[part][idx - int(self.offsets[part])]


def build_train_dataset(config):
    """Registry + num_copies factory from the dataset config group."""
    datasets, copies = [], []
    for name, spec in config.dataset.roots.items():
        cls = DATASET_REGISTRY[spec.get("type", name)]
        datasets.append(cls(
            ann_file=spec["ann_file"],
            img_root=spec.get("img_root", ""),
            lmdb_path=spec.get("lmdb_path"),
            overfit=bool(config.dataset.overfit),
        ))
        copies.append(int(config.dataset.num_copies.get(name, 1)))
    return ConcatDataset(datasets, copies)


def pad_targets(targets: list[dict], max_boxes: int, num_attr_classes: int = 0) -> dict:
    """List of per-image targets -> fixed-shape padded arrays for the criterion."""
    b = len(targets)
    out = {
        "labels": np.zeros((b, max_boxes), np.int32),
        "boxes": np.zeros((b, max_boxes, 4), np.float32),
        "valid": np.zeros((b, max_boxes), bool),
    }
    if num_attr_classes:
        out["attributes"] = np.zeros((b, max_boxes, num_attr_classes), np.float32)
        out["has_attr"] = np.zeros(b, bool)
    for i, t in enumerate(targets):
        n = min(len(t["labels"]), max_boxes)
        out["labels"][i, :n] = t["labels"][:n]
        out["boxes"][i, :n] = t["boxes"][:n]
        out["valid"][i, :n] = True
        if num_attr_classes and "attributes" in t and len(t["attributes"]):
            out["attributes"][i, :n] = t["attributes"][:n]
            out["has_attr"][i] = t.get("has_attr", True)
    return out
