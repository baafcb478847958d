"""COCO online-server evaluation CLI (reference eval_caption_online.py:19-71;
grit_tpu's root eval_caption_online.py, whose overrides it takes).

Writes ``result_test.json`` / ``result_valid.json`` (the leaderboard's
submission format) from the COCO test2014 / val2014 images under
``$DATA_ROOT``:

  python -m grit_tpu_torch.eval_caption_online exp.checkpoint=ckpt [overrides...]

Every image is resized by ``minmax_resize(·, (384, 640))`` (the reference's
TestDataset, datasets/caption/coco.py:134-135) and padded into one 640x640
bucket, 16 images a batch; the model computes in bf16.  ``online_batches``
builds the batches from the image files and ``engine.evaluator
.caption_batches`` captions them, so the caption loop also runs on arrays.
``exp.device`` (or ``--device``) defaults to ``cuda``, and the CLI raises
without a card; ``exp.device=cpu`` runs on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ONLINE_SIZE = (384, 640)       # minmax_resize's (shorter side, longer side)
ONLINE_BUCKET = (640, 640)
ONLINE_BATCH = 16


def online_array(path: str) -> np.ndarray:
    """One image file -> float32 [H, W, 3], minmax-resized and normalized."""
    from PIL import Image

    from grit_tpu_torch.data.transforms import minmax_resize, to_normalized_array

    with Image.open(path) as im:
        return to_normalized_array(minmax_resize(im.convert("RGB"), ONLINE_SIZE))


def online_batches(images: list[dict], img_root: str, batch: int = ONLINE_BATCH):
    """COCO image-info entries (``file_name``, ``id``) -> (ImageBatch in the
    640x640 bucket, [image id, ...]) per ``batch`` images."""
    from grit_tpu_torch.utils.nested import batch_images

    for s in range(0, len(images), batch):
        chunk = images[s:s + batch]
        arrs = [online_array(os.path.join(img_root, info["file_name"])) for info in chunk]
        yield batch_images(arrs, bucket_hw=ONLINE_BUCKET), [info["id"] for info in chunk]


def main(argv=None):
    from grit_tpu_torch.data.field import TextField
    from grit_tpu_torch.engine.evaluator import caption_batches, make_caption_generator
    from grit_tpu_torch.eval_caption import caption_config, config_device, load_captioner

    config = caption_config(sys.argv[1:] if argv is None else argv)
    device = config_device(config, "eval_caption_online")
    model = load_captioner(config, device, torch.bfloat16, config.exp.checkpoint)
    text_field = TextField(vocab_path=config.dataset.vocab_path)
    m = config.model
    generate = make_caption_generator(model, beam_size=m.beam_size, max_len=m.beam_len,
                                      bos_idx=m.bos_idx, eos_idx=m.eos_idx)
    data_root = os.environ.get("DATA_ROOT", "")
    splits = {
        "test": (os.path.join(data_root, "test2014"),
                 os.path.join(data_root, "annotations/image_info_test2014.json")),
        "valid": (os.path.join(data_root, "val2014"),
                  os.path.join(data_root, "annotations/captions_val2014.json")),
    }
    for split, (root, ann) in splits.items():
        with open(ann) as f:
            images = json.load(f)["images"]
        results = caption_batches(generate, online_batches(images, root), text_field,
                                  device=device)
        with open(f"result_{split}.json", "w") as f:
            json.dump(results, f)
        print(f"wrote result_{split}.json ({len(results)} captions)")


if __name__ == "__main__":
    main()
