"""COCO Karpathy-split caption data pipeline.

Capability parity with the reference pipeline (datasets/caption/coco.py)
without pycocotools or torch DataLoaders:

- Karpathy splits from the shipped ``coco_{train,dev,test,restval}_ids.npy``
  annotation-id files, with ``use_restval`` folding restval into train
  (coco.py:214-225) and ``cut_validation`` truncation (:218-219);
- paired dataset (image, caption tokens) for XE and dictionary dataset
  (image -> all 5 refs) for SCST/eval (:84-101, :151-176);
- hdf5 fast path for frozen precomputed features (field.py:47-68);
- batch-size rules: freezing x4, SCST //sc_batch_divisor (default 2; the
  reference uses //4), dict eval x2 (coco.py:339-366);
- overfit-64 smoke mode incl. the valid-for-train substitution (:24,:301-302);
- test-server datasets for the COCO leaderboard (:119-148).

Kept from grit_tpu.data.coco, batch for batch:
- captions pad to the FIXED config max length, and images pad to the fixed
  transform bucket, so every batch of a run has one shape;
- the loader shards by (rank, world) slicing like DistributedSampler and
  prefetches with a thread pool (host-side PIL work overlaps device steps).

Batches are numpy arrays and CPU ``ImageBatch``es
(``grit_tpu_torch.utils.nested.batch_images``); the training loops move them
to the model's device.  ``PIL`` and ``h5py`` are imported inside the
functions that need them.
"""

from __future__ import annotations

import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple, Sequence

import numpy as np

from grit_tpu_torch.data.field import TextField
from grit_tpu_torch.data.transforms import get_transform
from grit_tpu_torch.utils.nested import batch_images

OVERFIT_SIZE = 64


class CocoExample(NamedTuple):
    image_id: int
    image: str      # file path
    text: str
    tokens: list


def _load_ann_index(cap_file: str):
    """captions_*.json -> (ann_id -> (image_id, caption), image_id -> file_name)."""
    data = json.load(open(cap_file))
    anns = {a["id"]: (a["image_id"], a["caption"]) for a in data["annotations"]}
    imgs = {im["id"]: im["file_name"] for im in data["images"]}
    return anns, imgs


def load_karpathy_examples(
    ann_root: str,
    img_root: str,
    text_field: TextField,
    use_restval: bool = True,
    cut_validation: bool = False,
    overfit: bool = False,
) -> dict:
    """-> {'train': [...], 'valid': [...], 'test': [...]} of CocoExample."""
    train_anns, train_imgs = _load_ann_index(
        os.path.join(ann_root, "captions_train2014.json")
    )
    val_anns, val_imgs = _load_ann_index(
        os.path.join(ann_root, "captions_val2014.json")
    )
    sources = {
        "train2014": (train_anns, train_imgs, os.path.join(img_root, "train2014")),
        "val2014": (val_anns, val_imgs, os.path.join(img_root, "val2014")),
    }

    def build(ids, source_names):
        out = []
        for ids_arr, sname in zip(ids, source_names):
            anns, imgs, root = sources[sname]
            for ann_id in ids_arr:
                ann_id = int(ann_id)
                if ann_id not in anns:
                    continue
                image_id, caption = anns[ann_id]
                toks = text_field.preprocess(caption)
                out.append(CocoExample(
                    image_id=image_id,
                    image=os.path.join(root, imgs[image_id]),
                    text=caption,
                    tokens=[text_field.vocab.stoi(w) for w in toks],
                ))
        return out

    ids = {
        "train": np.load(os.path.join(ann_root, "coco_train_ids.npy")),
        "valid": np.load(os.path.join(ann_root, "coco_dev_ids.npy")),
        "test": np.load(os.path.join(ann_root, "coco_test_ids.npy")),
    }
    if cut_validation:
        ids["valid"] = ids["valid"][:5000]

    examples = {}
    if not overfit:
        if use_restval:
            restval = np.load(os.path.join(ann_root, "coco_restval_ids.npy"))
            examples["train"] = build(
                [ids["train"], restval], ["train2014", "val2014"]
            )
        else:
            examples["train"] = build([ids["train"]], ["train2014"])
    examples["valid"] = build([ids["valid"]], ["val2014"])
    examples["test"] = build([ids["test"]], ["val2014"])
    if overfit:
        examples["train"] = examples["valid"]  # overfit substitution (:301-302)
    return examples


class PairedDataset:
    """(image, caption tokens, image_id) pairs — one item per annotation."""

    def __init__(self, examples: Sequence[CocoExample], overfit: bool = False):
        self.examples = examples
        self.overfit = overfit

    def __len__(self):
        if self.overfit:
            return min(OVERFIT_SIZE, len(self.examples))
        return len(self.examples)

    def __getitem__(self, idx: int) -> CocoExample:
        return self.examples[idx]


class DictionaryDataset:
    """One item per image with all its reference captions (SCST/eval)."""

    def __init__(self, examples: Sequence[CocoExample], overfit: bool = False):
        self.by_image: dict[str, list[CocoExample]] = {}
        for ex in examples:
            self.by_image.setdefault(ex.image, []).append(ex)
        self.paths = list(self.by_image.keys())
        self.overfit = overfit

    def __len__(self):
        if self.overfit:
            return min(OVERFIT_SIZE, len(self.paths))
        return len(self.paths)

    def __getitem__(self, idx: int):
        exs = self.by_image[self.paths[idx]]
        return exs[0].image, [e.text for e in exs], exs[0].image_id


class HDF5FeatureReader:
    """Frozen-feature fast path (reference field.py:40-68)."""

    def __init__(self, hdf5_path: str, use_gri_feat=True, use_reg_feat=True):
        import h5py

        self.path = hdf5_path
        self.use_gri_feat = use_gri_feat
        self.use_reg_feat = use_reg_feat
        with h5py.File(hdf5_path, "r") as f:
            self.img_id2idx = {int(i): n for n, i in enumerate(f["image_ids"][:])}
        self._file = None

    def read(self, image_id: int) -> dict:
        import h5py

        if self._file is None:
            self._file = h5py.File(self.path, "r")
        idx = self.img_id2idx[int(image_id)]
        out = {}
        if self.use_gri_feat:
            out["gri_feat"] = self._file["gri_feat"][idx]
            out["gri_mask"] = self._file["gri_mask"][idx]
        if self.use_reg_feat:
            out["reg_feat"] = self._file["reg_feat"][idx]
            out["reg_mask"] = self._file["reg_mask"][idx]
        return out


def pad_captions(
    token_lists: Sequence[list], max_len: int, pad_idx=1, bos_idx=2, eos_idx=3
) -> np.ndarray:
    """[BOS, tokens..., EOS, PAD...] to the fixed max_len + 2."""
    out = np.full((len(token_lists), max_len + 2), pad_idx, np.int32)
    for i, toks in enumerate(token_lists):
        toks = list(toks)[:max_len]
        out[i, 0] = bos_idx
        out[i, 1:1 + len(toks)] = toks
        out[i, 1 + len(toks)] = eos_idx
    return out


class CocoLoader:
    """Sharded, shuffled, prefetching batch loader.

    Yields dict batches matching the reference collators' keys
    (coco.py:27-81): ``samples`` (ImageBatch or feature dict), ``captions``
    (padded ids for paired mode, list-of-refs for dict mode), ``image_id``.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        transform=None,
        hdf5: HDF5FeatureReader | None = None,
        mode: str = "paired",          # 'paired' | 'dict' | 'test'
        max_len: int = 54,
        pad_idx: int = 1,
        bos_idx: int = 2,
        eos_idx: int = 3,
        bucket_hw=(384, 640),
        shuffle: bool = False,
        drop_last: bool = False,
        rank: int = 0,
        world: int = 1,
        seed: int = 42,
        num_workers: int = 8,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.hdf5 = hdf5
        self.mode = mode
        self.max_len = max_len
        self.pad_idx, self.bos_idx, self.eos_idx = pad_idx, bos_idx, eos_idx
        self.bucket_hw = tuple(bucket_hw)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rank, self.world = rank, world
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _pool(self) -> ThreadPoolExecutor:
        if getattr(self, "_pool_obj", None) is None:
            self._pool_obj = ThreadPoolExecutor(self.num_workers)
        return self._pool_obj

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.rank::self.world]

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_image(self, path: str):
        from PIL import Image

        with Image.open(path) as im:
            return self.transform(im)

    def _make_batch(self, items):
        batch: dict = {}
        if self.mode == "paired":
            image_ids = [ex.image_id for ex in items]
            tokens = [ex.tokens for ex in items]
            batch["captions"] = pad_captions(
                tokens, self.max_len, self.pad_idx, self.bos_idx, self.eos_idx
            )
            paths = [ex.image for ex in items]
        elif self.mode == "dict":
            paths = [it[0] for it in items]
            batch["captions"] = [it[1] for it in items]
            image_ids = [it[2] for it in items]
        else:  # test
            paths = [it[0] for it in items]
            image_ids = [it[1] for it in items]

        if self.hdf5 is not None:
            feats = [self.hdf5.read(i) for i in image_ids]
            batch["samples"] = {
                k: np.stack([f[k] for f in feats]) for k in feats[0]
            }
        else:
            imgs = list(self._pool().map(self._load_image, paths))
            batch["samples"] = batch_images(imgs, bucket_hw=self.bucket_hw)
        batch["image_id"] = image_ids
        return batch

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        n_batches = len(self)

        # Batch-level parallel prefetch: ``prefetch`` batches are built
        # concurrently (jpeg decode, RandAugment and resize mostly release
        # the GIL) and emitted strictly in order, so determinism holds: item
        # RNGs are keyed by dataset index + epoch, not call order.
        prefetch = min(4, max(1, self.num_workers // 2))

        def build(b: int):
            rows = idx[b * self.batch_size:(b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in rows]
            return self._make_batch(items)

        # batch-level pool is SEPARATE from the per-image pool _make_batch
        # maps over — submitting builds to that same pool could deadlock
        # (all workers running builds, none left for their image loads)
        if getattr(self, "_batch_pool", None) is None:
            self._batch_pool = ThreadPoolExecutor(prefetch)
        pool = self._batch_pool
        pending: deque = deque()
        nxt = 0
        while nxt < min(prefetch, n_batches):
            pending.append(pool.submit(build, nxt))
            nxt += 1
        while pending:
            batch = pending.popleft().result()
            if nxt < n_batches:
                pending.append(pool.submit(build, nxt))
                nxt += 1
            yield batch


def build_coco_dataloaders(config, mode: str = "finetune", rank: int = 0, world: int = 1):
    """Factory matching the reference's loader dict + batch-size rules
    (coco.py:306-387).  Returns (loaders, loaders-as-samplers)."""
    overfit = bool(config.dataset.overfit)
    transform = get_transform(config.dataset.transform_cfg)
    text_field = TextField(vocab_path=config.dataset.vocab_path)
    examples = load_karpathy_examples(
        config.dataset.ann_root, config.dataset.img_root, text_field,
        overfit=overfit,
    )

    hdf5 = None
    if mode == "freezing" and config.optimizer.get("freezing_xe_epochs", 0) > 0:
        hdf5 = HDF5FeatureReader(
            config.dataset.hdf5_path,
            use_gri_feat=config.model.use_gri_feat,
            use_reg_feat=config.model.use_reg_feat,
        )

    bs = config.optimizer.batch_size * 4 if mode == "freezing" else config.optimizer.batch_size
    # SCST batch: the reference's rule is batch//4 (train_caption.py:253), a
    # memory convention, not math: the SCST loss and gradient are exactly
    # linear in batch size.  Default divisor 2 (= b8 at the production batch
    # 16), as grit_tpu; set optimizer.sc_batch_divisor=4 for the reference
    # recipe.
    sc_div = int(config.optimizer.get("sc_batch_divisor", 2))
    sc_bs = (config.optimizer.batch_size if mode == "freezing"
             else max(1, config.optimizer.batch_size // sc_div))

    common = dict(
        max_len=config.model.max_len,
        pad_idx=config.model.pad_idx,
        bos_idx=config.model.bos_idx,
        eos_idx=config.model.eos_idx,
        bucket_hw=tuple(config.dataset.transform_cfg.size),
        num_workers=config.optimizer.get("num_workers", 8),
        seed=config.exp.seed,
    )
    datasets = {
        "train": PairedDataset(examples["train"], overfit),
        "valid": PairedDataset(examples["valid"], overfit),
        "train_dict": DictionaryDataset(examples["train"], overfit),
        "valid_dict": DictionaryDataset(examples["valid"], overfit),
        "test_dict": DictionaryDataset(examples["test"], overfit),
    }
    loaders = {
        "train": CocoLoader(
            datasets["train"], bs, transform=transform["train"], hdf5=hdf5,
            mode="paired", shuffle=True, drop_last=True, rank=rank, world=world,
            **common,
        ),
        "valid": CocoLoader(
            datasets["valid"], bs, transform=transform["valid"], hdf5=hdf5,
            mode="paired", rank=rank, world=world, **common,
        ),
        "train_dict": CocoLoader(
            datasets["train_dict"], max(2, sc_bs), transform=transform["train"],
            hdf5=hdf5, mode="dict", shuffle=True, drop_last=True,
            rank=rank, world=world, **common,
        ),
        "valid_dict": CocoLoader(
            datasets["valid_dict"], max(1, sc_bs * 2), transform=transform["valid"],
            hdf5=hdf5, mode="dict", **common,
        ),
        "test_dict": CocoLoader(
            datasets["test_dict"], max(1, sc_bs * 2), transform=transform["valid"],
            hdf5=hdf5, mode="dict", **common,
        ),
    }
    return loaders, {k: loaders[k] for k in ("train", "valid", "train_dict")}
