"""NoCaps zero-shot evaluation CLI (reference eval_nocaps.py + nocaps.py;
grit_tpu's root eval_nocaps.py, whose arguments it takes).

Captions the nocaps validation images and writes the submission JSON.  The
nocaps annotation file is in COCO image-info format.

  python -m grit_tpu_torch.eval_nocaps --checkpoint ckpt --ann nocaps_val.json \
      --img-root dir [--out nocaps_val_results.json] [--batch 16] [--device cuda] \
      [overrides...]

Images go through the config's validation transform into its bucket
(``dataset.transform_cfg.size``); the model computes in bf16.
``nocaps_batches`` builds the batches from the image files and
``engine.evaluator.caption_batches`` captions them.  ``--device`` (or
``exp.device``) defaults to ``cuda``, and the CLI raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


class NocapsDataset:
    """nocaps val images (reference datasets/caption/nocaps.py:12)."""

    def __init__(self, ann_file: str, img_root: str, transform):
        with open(ann_file) as f:
            self.images = json.load(f)["images"]
        self.img_root = img_root
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        from PIL import Image

        info = self.images[idx]
        with Image.open(os.path.join(self.img_root, info["file_name"])) as im:
            return self.transform(im), info["id"]


def nocaps_batches(dataset: NocapsDataset, bucket_hw, batch: int):
    """-> (ImageBatch in ``bucket_hw``, [image id, ...]) per ``batch`` images."""
    from grit_tpu_torch.utils.nested import batch_images

    for s in range(0, len(dataset), batch):
        items = [dataset[i] for i in range(s, min(s + batch, len(dataset)))]
        yield (batch_images([it[0] for it in items], bucket_hw=tuple(bucket_hw)),
               [it[1] for it in items])


def main(argv=None):
    from grit_tpu_torch.data.field import TextField
    from grit_tpu_torch.data.transforms import get_transform
    from grit_tpu_torch.engine.evaluator import caption_batches, make_caption_generator
    from grit_tpu_torch.eval_caption import caption_config, config_device, load_captioner

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-root", required=True)
    ap.add_argument("--out", default="nocaps_val_results.json")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default=None)
    args, overrides = ap.parse_known_args(argv)

    config = caption_config(overrides)
    if args.device:
        config.exp.device = args.device
    device = config_device(config, "eval_nocaps")
    model = load_captioner(config, device, torch.bfloat16, args.checkpoint)
    text_field = TextField(vocab_path=config.dataset.vocab_path)
    dataset = NocapsDataset(args.ann, args.img_root,
                            get_transform(config.dataset.transform_cfg)["valid"])
    m = config.model
    generate = make_caption_generator(model, beam_size=m.beam_size, max_len=m.beam_len,
                                      bos_idx=m.bos_idx, eos_idx=m.eos_idx)
    results = caption_batches(
        generate, nocaps_batches(dataset, config.dataset.transform_cfg.size, args.batch),
        text_field, device=device)
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(f"wrote {len(results)} captions to {args.out}")


if __name__ == "__main__":
    main()
