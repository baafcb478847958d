"""Frozen-detector feature pre-extraction -> hdf5 (reference
tools/extract_features.py; grit_tpu's tools/extract_features.py, whose
overrides it takes).

  python -m grit_tpu_torch.tools.extract_features [overrides...]

Runs the captioner's detector in bf16, with the weights of
``model.detector.checkpoint`` where that file exists (seed-0 random weights
otherwise), over every image of the train, valid and test splits, and
writes one row per unique image id to ``dataset.hdf5_path``: ``image_ids``,
``gri_feat`` / ``reg_feat`` as float16 and ``gri_mask`` / ``reg_mask`` as
bool, the layout that the freezing mode's ``data.coco.HDF5FeatureReader``
reads.  ``collect_vis_features`` returns the arrays (no h5py);
``write_vis_features`` writes them.  ``exp.device`` (or ``--device``)
defaults to ``cuda``, and the tool raises without a card.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

SPLITS = ("train_dict", "valid_dict", "test_dict")
FEATURES = ("gri_feat", "gri_mask", "reg_feat", "reg_mask")


@torch.inference_mode()
def collect_vis_features(detector, loaders, device) -> dict[str, np.ndarray]:
    """The detector's features of every image the ``loaders`` (each yielding
    ``{"samples": ImageBatch, "image_id": [...]}``) hold, the first time its
    id appears: ``image_ids`` and ``FEATURES`` as numpy, features float16."""
    from grit_tpu_torch.utils.nested import to_device

    seen: set = set()
    ids, parts = [], {k: [] for k in FEATURES}
    for loader in loaders:
        for batch in loader:
            keep = [i for i, img_id in enumerate(batch["image_id"]) if int(img_id) not in seen]
            if not keep:
                continue
            vis = detector(to_device(batch["samples"], device))
            for k in FEATURES:
                x = vis[k][keep]
                parts[k].append((x.half() if x.is_floating_point() else x).cpu().numpy())
            new = [int(batch["image_id"][i]) for i in keep]
            seen.update(new)
            ids += new
    return {"image_ids": np.asarray(ids), **{k: np.concatenate(v) for k, v in parts.items()}}


def write_vis_features(path: str, feats: dict[str, np.ndarray], paths=None) -> None:
    """``collect_vis_features``' arrays (and, where given, each row's image
    path) into one hdf5 file."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("image_ids", data=feats["image_ids"])
        if paths is not None:
            f.create_dataset("paths", data=np.asarray(paths, dtype="S"))
        for k in FEATURES:
            f.create_dataset(k, data=feats[k])


def load_detector_weights(detector, path: str) -> None:
    """A reference detector ``.pth`` into ``detector`` in place, strict=False
    style, when ``path`` names a file."""
    from grit_tpu_torch.convert import load_reference_checkpoint
    from grit_tpu_torch.engine.checkpoint import load_params_flexible

    if path and os.path.exists(path):
        miss, unexp = load_params_flexible(detector, load_reference_checkpoint(path))
        print(f"detector load: missing={miss} unexpected={unexp}")


def extract_vis_features(detector, dataloaders: dict, device, out_path: str) -> None:
    """One row per unique image across the train, valid and test dict loaders
    (which iterate images, not captions), so the file serves every split."""
    feats = collect_vis_features(detector, [dataloaders[name] for name in SPLITS], device)
    write_vis_features(out_path, feats)
    print(f"wrote {len(feats['image_ids'])} image features to {out_path}")


def main(argv=None):
    from grit_tpu_torch.data.coco import build_coco_dataloaders
    from grit_tpu_torch.eval_caption import caption_config, config_device
    from grit_tpu_torch.models.captioner import build_detector

    config = caption_config(sys.argv[1:] if argv is None else argv)
    device = config_device(config, "extract_features")
    detector = build_detector(config, device=device, dtype=torch.bfloat16, seed=0)
    load_detector_weights(detector, config.model.detector.checkpoint)
    dataloaders, _ = build_coco_dataloaders(config, mode="finetune")
    extract_vis_features(detector, dataloaders, device, config.dataset.hdf5_path)


if __name__ == "__main__":
    main()
