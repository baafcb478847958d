"""Production detection batch loader: sharded, shuffled, prefetching.

Parity: the reference feeds the detector through ``DistributedSampler`` +
``BatchSampler(drop_last=True)`` + a multi-worker ``DataLoader`` with
``prefetch_factor=2`` (train_detector.py:167-176).  The equivalent here:

- per-process sharding by ``indices[rank::world]`` after a seed+epoch
  shuffle (DistributedSampler semantics; the caption loader,
  grit_tpu_torch/data/coco.py, uses the same scheme), with as many batches
  on every rank as one process would run at ``batch_size * world``;
- a thread pool decodes + transforms the batch's images concurrently
  (``num_workers``, reference ``optimizer.num_workers``), and ``prefetch``
  batches build concurrently on a batch-level pool, emitted strictly in
  order (prefetch_factor=2) so host work overlaps the device step;
- ``drop_last`` on train batches — the solver refuses ragged detection
  batches (a padded fake image would add background focal-loss terms);
- **static-shape bucketing**: the reference pads each batch to its own max
  size (engine/utils.py:278-295).  With ``bucket_hw`` set, every batch pads
  to ONE fixed (H, W): one set of shapes for the whole run, so the allocator
  and every kernel see the same sizes each step.  ``bucket_hw=None``
  reproduces per-batch pad-to-max (CPU tests / small runs).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from grit_tpu_torch.detection.datasets import pad_targets
from grit_tpu_torch.utils.nested import batch_images


class DetectionLoader:
    """Yields train batches ``{'samples': ImageBatch, 'targets': dict}`` or
    valid batches ``{'samples', 'orig_sizes', 'image_id'}``."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        transform,
        mode: str = "train",              # 'train' | 'valid'
        max_boxes: int = 100,
        num_attr_classes: int = 0,
        bucket_hw: Optional[tuple] = None,
        shuffle: bool = True,
        drop_last: bool = True,
        rank: int = 0,
        world: int = 1,
        seed: int = 42,
        num_workers: int = 4,
        prefetch: int = 2,
    ):
        if mode not in ("train", "valid"):
            raise ValueError(f"mode={mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.mode = mode
        self.max_boxes = max_boxes
        self.num_attr_classes = num_attr_classes
        self.bucket_hw = tuple(bucket_hw) if bucket_hw else None
        self.shuffle = shuffle and mode == "train"
        self.drop_last = drop_last and mode == "train"
        self.rank, self.world = rank, world
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._pool_obj: Optional[ThreadPoolExecutor] = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _pool(self) -> ThreadPoolExecutor:
        if self._pool_obj is None:
            self._pool_obj = ThreadPoolExecutor(self.num_workers)
        return self._pool_obj

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[self.rank::self.world]

    def __len__(self):
        """The one-process count at the global batch ``batch_size * world``,
        the same on every rank (``data.coco.CocoLoader.__len__``).  Training
        drops the short tail: a padded image would add background focal-loss
        terms.  In validation a rank's share of the last batch may be short or
        empty (no ``image_id``)."""
        n, per_step = len(self.dataset), self.batch_size * self.world
        return n // per_step if self.drop_last else -(-n // per_step)

    def _load_item(self, i: int):
        from grit_tpu_torch.detection.det_transforms import seed_item_rng

        # per-item augmentation seed: a pure function of (seed, epoch, index)
        # — deterministic across worker counts and across kill-and-resume
        seed_item_rng((self.seed * 1_000_003 + self.epoch * 7919 + int(i))
                      % (2 ** 32))
        img, tgt = self.dataset[int(i)]
        arr, tgt = self.transform(img, tgt)
        return arr, tgt

    def _make_batch(self, rows) -> dict:
        if not len(rows):
            return {"samples": None, "orig_sizes": np.zeros((0, 2), np.int64), "image_id": []}
        items = list(self._pool().map(self._load_item, rows))
        imgs = [arr for arr, _ in items]
        tgts = [tgt for _, tgt in items]
        if self.bucket_hw is not None:
            samples = batch_images(imgs, bucket_hw=self.bucket_hw)
        else:
            samples = batch_images(imgs, pad_multiple=64)
        if self.mode == "valid":
            return {
                "samples": samples,
                "orig_sizes": np.asarray([t["orig_size"] for t in tgts]),
                "image_id": [t["image_id"] for t in tgts],
            }
        targets = pad_targets(tgts, self.max_boxes, self.num_attr_classes)
        return {"samples": samples, "targets": targets}

    def __iter__(self):
        idx = self._indices()
        n_batches = len(self)

        # batch-LEVEL parallel prefetch (mirrors grit_tpu_torch/data/coco.py):
        # ``prefetch`` batches build concurrently on a dedicated pool and are
        # emitted strictly in submission order, so determinism — per-item
        # RNGs are keyed by (index, epoch) — is unchanged.  The build pool
        # is separate from the per-image pool _make_batch maps over
        # (same-pool submission could deadlock).
        from collections import deque

        def build(b: int):
            rows = idx[b * self.batch_size:(b + 1) * self.batch_size]
            return self._make_batch(rows)

        if getattr(self, "_batch_pool", None) is None:
            self._batch_pool = ThreadPoolExecutor(max(1, min(self.prefetch, 4)))
        pending: deque = deque()
        nxt = 0
        depth = max(1, self.prefetch)
        while nxt < min(depth, n_batches):
            pending.append(self._batch_pool.submit(build, nxt))
            nxt += 1
        try:
            while pending:
                batch = pending.popleft().result()
                if nxt < n_batches:
                    pending.append(self._batch_pool.submit(build, nxt))
                    nxt += 1
                yield batch
        finally:
            for f in pending:
                f.cancel()
