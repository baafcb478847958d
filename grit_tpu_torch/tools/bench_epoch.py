"""End-to-end recipe wall clock of the port: one XE and one SCST epoch of the
real training CLI on a synthetic COCO, and the host loader alone (the
counterpart of the JAX package's tools/bench_epoch.py).

  python -m grit_tpu_torch.tools.bench_epoch [--root DIR] [--images 1600]
      [--wh 640 480] [--val-images 128] [--batch 16] [--loader-only]
      [--skip-data] [overrides...]

It writes a Karpathy-format COCO (``--images`` train images of ``--wh``
pixels, five captions each from a small vocabulary; ``--val-images`` more,
half valid and half test) under ``--root``, by default a temporary
directory that is removed at the end, never inside the repository.  Then it
times the host input pipeline alone (``data.coco.build_coco_dataloaders``'
train loader: decode, transforms, collate, prefetch; sustained images/s with
the device out of the loop) and drives ``python -m
grit_tpu_torch.train_caption`` in a subprocess, from the data directory, for
one XE and one SCST epoch with their evaluations and checkpoints, and
reports the subprocess's wall time.  Dotted overrides go to both; the
trainer runs on the card unless ``exp.device=cpu`` (or ``--device cpu``) is
given, and without a card and without it the tool raises before writing
anything.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
WORDS = ("a the red blue green small large cat dog person car tree road sky "
         "water grass table chair light dark near far on under over with and "
         "running sitting standing looking holding").split()


def make_synth_coco(root: str, n_images: int, wh: tuple[int, int], n_val: int = 128) -> int:
    """A Karpathy-format COCO at ``root`` -> the vocabulary's size.

    Images are smooth gradients with a few rectangles (JPEG, so decoding costs
    what a photo's does), five captions each from ``WORDS``; ``n_val``
    validation-set images, the first half the dev split and the rest test."""
    from PIL import Image

    from grit_tpu_torch.data.vocab import Vocab

    w, h = wh
    ann = os.path.join(root, "annotations")
    for d in (ann, os.path.join(root, "train2014"), os.path.join(root, "val2014")):
        os.makedirs(d, exist_ok=True)

    def write_img(path, seed):
        r = np.random.RandomState(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        img = ((xx * (r.rand() * 255 / w))[..., None] * np.asarray([1, 0.5, 0.25])
               + (yy * (r.rand() * 255 / h))[..., None] * np.asarray([0.25, 1, 0.5]))
        img = img.astype(np.float32)
        for _ in range(6):
            x0, y0 = r.randint(0, max(w - 40, 1)), r.randint(0, max(h - 40, 1))
            dw, dh = r.randint(20, max(w // 3, 21)), r.randint(20, max(h // 3, 21))
            img[y0:y0 + dh, x0:x0 + dw] = r.randint(0, 255, 3)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=85)

    def caption(r):
        return " ".join(WORDS[r.randint(0, len(WORDS))] for _ in range(r.randint(6, 12)))

    def split(name, img_dir, ids, ann_start):
        images, anns = [], []
        for img_id in ids:
            fname = f"{name}_{img_id:012d}.jpg"
            write_img(os.path.join(root, img_dir, fname), img_id)
            images.append({"id": img_id, "file_name": fname, "height": h, "width": w})
            r = np.random.RandomState(10_000 + img_id)
            for j in range(5):
                anns.append({"id": ann_start + img_id * 10 + j, "image_id": img_id,
                             "caption": caption(r)})
        return {"images": images, "annotations": anns}

    t0 = time.perf_counter()
    val_start = 700_000
    train = split("COCO_train2014", "train2014", range(1, n_images + 1), 0)
    val = split("COCO_val2014", "val2014", range(val_start, val_start + n_val), 50_000_000)
    for fname, data in (("captions_train2014.json", train), ("captions_val2014.json", val)):
        with open(os.path.join(ann, fname), "w") as f:
            json.dump(data, f)
    half = val_start + n_val // 2
    np.save(os.path.join(ann, "coco_train_ids.npy"),
            np.asarray([a["id"] for a in train["annotations"]]))
    np.save(os.path.join(ann, "coco_dev_ids.npy"),
            np.asarray([a["id"] for a in val["annotations"] if a["image_id"] < half]))
    np.save(os.path.join(ann, "coco_test_ids.npy"),
            np.asarray([a["id"] for a in val["annotations"] if a["image_id"] >= half]))
    np.save(os.path.join(ann, "coco_restval_ids.npy"), np.asarray([], np.int64))
    vocab = Vocab(counter=collections.Counter({wd: 5 for wd in WORDS}))
    vocab.save(os.path.join(ann, "vocab.json"))
    print(f"dataset: {n_images} train images ({w}x{h}), {len(train['annotations'])} captions, "
          f"{n_val} validation images, built in {time.perf_counter() - t0:.1f} s", flush=True)
    return len(vocab.itos)


def measure_loader(root: str, vocab_size: int, batch: int, overrides, batches: int = 30) -> float:
    """The host pipeline alone: sustained images/s through the trainer's train
    loader (decode, transforms, collate, prefetch), the device untouched."""
    from grit_tpu_torch.config import default_caption_config
    from grit_tpu_torch.data.coco import build_coco_dataloaders

    os.environ["DATA_ROOT"] = root
    config = default_caption_config().apply_overrides(
        [f"model.vocab_size={vocab_size}", f"optimizer.batch_size={batch}", *overrides])
    loaders, _ = build_coco_dataloaders(config, mode="finetune", rank=0, world=1)

    def forever():
        epoch = 0
        while True:
            loaders["train"].set_epoch(epoch)
            yield from loaders["train"]
            epoch += 1

    it = forever()
    for _ in range(3):   # the pool's warm-up
        next(it)
    t0 = time.perf_counter()
    n = sum(len(next(it)["captions"]) for _ in range(batches))
    dt = time.perf_counter() - t0
    print(f"loader-only sustained: {n / dt:.1f} img/s host capacity "
          f"({dt / batches * 1e3:.0f} ms/batch at b{batch})", flush=True)
    return n / dt


def main(argv=None) -> dict:
    from grit_tpu_torch.eval_caption import caption_config, config_device

    ap = argparse.ArgumentParser(prog="python -m grit_tpu_torch.tools.bench_epoch")
    ap.add_argument("--root", default=None,
                    help="where to write the dataset (default: a temporary directory)")
    ap.add_argument("--images", type=int, default=1600)
    ap.add_argument("--wh", type=int, nargs=2, default=(640, 480))
    ap.add_argument("--val-images", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--loader-only", action="store_true")
    ap.add_argument("--skip-data", action="store_true",
                    help="reuse the dataset already at --root")
    args, overrides = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    if "--device" in overrides:
        i = overrides.index("--device")
        overrides[i:i + 2] = [f"exp.device={overrides[i + 1]}"]
    device = config_device(caption_config(overrides), "bench_epoch")   # raises without a card
    if args.skip_data and not args.root:
        ap.error("--skip-data needs --root")
    root = args.root or tempfile.mkdtemp(prefix="grit_epoch_")
    if Path(root).resolve().is_relative_to(REPO):
        ap.error(f"--root {root} lies inside the repository; write the dataset elsewhere")
    try:
        if args.skip_data:
            from grit_tpu_torch.data.vocab import Vocab

            v = len(Vocab(vocab_path=os.path.join(root, "annotations", "vocab.json")).itos)
        else:
            v = make_synth_coco(root, args.images, tuple(args.wh), args.val_images)
        out = {"device": str(device), "root": root,
               "loader_images_per_s": measure_loader(root, v, args.batch, overrides)}
        if args.loader_only:
            return out
        cmd = [sys.executable, "-m", "grit_tpu_torch.train_caption", "exp.name=epoch_bench",
               f"model.vocab_size={v}", f"optimizer.batch_size={args.batch}",
               "optimizer.freezing_xe_epochs=0", "optimizer.freezing_sc_epochs=0",
               "optimizer.finetune_xe_epochs=1", "optimizer.finetune_sc_epochs=1", *overrides]
        env = dict(os.environ, DATA_ROOT=root,
                   PYTHONPATH=os.pathsep.join(p for p in (str(REPO),
                                                          os.environ.get("PYTHONPATH")) if p))
        print("driving:", " ".join(cmd[1:]), flush=True)
        t0 = time.perf_counter()
        rc = subprocess.call(cmd, env=env, cwd=root)
        wall = time.perf_counter() - t0
        print(f"TOTAL recipe wall (1 XE + 1 SCST epoch, evaluations, checkpoints): "
              f"{wall / 60:.2f} min ({wall:.1f} s, rc={rc}); host loader capacity "
              f"{out['loader_images_per_s']:.1f} img/s", flush=True)
        if rc != 0:
            raise RuntimeError(f"bench_epoch: the trainer exited with {rc}")
        out.update(wall_s=wall, results=(Path(root) / "outputs" / "epoch_bench").exists())
        return out
    finally:
        if not args.root:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
