"""ArtEmis feature pre-extraction (reference tools/artemis_extract_features.py:29;
grit_tpu's tools/artemis_extract_features.py, whose arguments it takes).

The flow of ``tools/extract_features.py`` over a JSON list of painting image
paths; writes the same hdf5 layout, plus ``paths`` (row i is image id i):

  python -m grit_tpu_torch.tools.artemis_extract_features --listing paintings.json \
      --img-root /data/wikiart --out artemis_feats.h5 [--checkpoint det.pth] \
      [--batch 16] [--device cuda] [overrides...]

Images go through the config's validation transform into its bucket; the
detector computes in bf16.  ``--device`` (or ``exp.device``) defaults to
``cuda``, and the tool raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def listing_batches(paths: list[str], img_root: str, transform, bucket_hw, batch: int):
    """-> ``{"samples": ImageBatch, "image_id": [row, ...]}`` per ``batch``
    paths, the image id of a path being its row in the listing."""
    from PIL import Image

    from grit_tpu_torch.utils.nested import batch_images

    for s in range(0, len(paths), batch):
        arrs = []
        for rel in paths[s:s + batch]:
            with Image.open(os.path.join(img_root, rel)) as im:
                arrs.append(transform(im))
        yield {"samples": batch_images(arrs, bucket_hw=tuple(bucket_hw)),
               "image_id": list(range(s, s + len(arrs)))}


def main(argv=None):
    from grit_tpu_torch.data.transforms import get_transform
    from grit_tpu_torch.eval_caption import caption_config, config_device
    from grit_tpu_torch.models.captioner import build_detector
    from grit_tpu_torch.tools.extract_features import (collect_vis_features,
                                                       load_detector_weights,
                                                       write_vis_features)

    ap = argparse.ArgumentParser()
    ap.add_argument("--listing", required=True, help="json list of relative image paths")
    ap.add_argument("--img-root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None)
    args, overrides = ap.parse_known_args(argv)

    config = caption_config(overrides)
    if args.device:
        config.exp.device = args.device
    device = config_device(config, "artemis_extract_features")
    detector = build_detector(config, device=device, dtype=torch.bfloat16, seed=0)
    load_detector_weights(detector, args.checkpoint)
    with open(args.listing) as f:
        paths = json.load(f)
    cfg = config.dataset.transform_cfg
    batches = listing_batches(paths, args.img_root, get_transform(cfg)["valid"], cfg.size,
                              args.batch)
    feats = collect_vis_features(detector, [batches], device)
    write_vis_features(args.out, feats, paths=paths)
    print(f"wrote {len(feats['image_ids'])} features to {args.out}")


if __name__ == "__main__":
    main()
