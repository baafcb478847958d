"""Detector pre-training CLI (reference train_detector.py; the JAX package's
root ``train_detector.py``).

Multi-dataset object-detection training of the Swin + deformable-decoder
detector, driven by the hook-based solver, on one device:

  python -m grit_tpu_torch.train_detector exp.name=det1 \\
      dataset.roots.coco.ann_file=... dataset.roots.coco.img_root=... ...

It takes the JAX CLI's dotted overrides, plus ``exp.device`` (default
``cuda``; ``exp.device=cpu`` runs the plain versions of the kernels, as the
tests do; without a card and without it, the CLI raises).  It computes in
fp32, as the JAX CLI does.

Parity with the reference recipe:
- 4-group AdamW + the sp group (train_detector.py:24-89): head /
  det_no_decay / backbone_no_decay / backbone_decay at lr / lr / lr_backbone /
  lr_backbone with decoupled weight decay on the decay groups, plus the
  parameters matching ``optimizer.sp_names`` at ``sp_lr`` with their own
  MultiStepLR (``sp_lr_drop_epochs``);
- MultiStepLR tick parity: the reference steps each scheduler once BEFORE the
  epoch loop (train_detector.py:245-246), so a milestone ``m`` first applies
  during 0-indexed epoch ``m - 1``: the hooks get the translated milestones;
- warm start from ``exp.checkpoint`` with the ``query_embed`` row trim when
  ``query_embed`` is in sp_names (train_detector.py:134-153), strict=False
  merge with missing/unexpected counts printed;
- full resume via ``exp.resume=true`` from ``detector_last`` in the workdir
  (parameters, optimizer state, step counter, epoch);
- the loader: seed+epoch shuffle, multi-worker decode and transform, depth-2
  prefetch, drop_last, the ``dataset.fixed_bucket`` static shape;
- host augmentation RNGs keyed by the epoch, so a resumed run's epoch E draws
  what an uninterrupted run's epoch E draws.

Data parallel: one process a card, started by ``torchrun``,

  torchrun --nproc_per_node N -m grit_tpu_torch.train_detector exp.name=det1 ...

(``parallel.distributed.maybe_initialize``; ``exp.world_size`` is ignored, as
in the JAX CLI: the launcher says how many ranks run).  ``optimizer.batch_size``
is per rank; each rank trains on its share of every global batch under
``DistributedDataParallel`` (the criterion's box count is the global
batch's, the clip the global norm), seeds its augmentation and dropout with
seed + rank, evaluates its shard of the validation sets (the predictions are
merged before the mAP), and rank 0 writes the checkpoints and logs.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def _trim_query_embed(state_dict: dict, num_queries: int) -> dict:
    """Trim loaded ``query_embed`` rows to ``num_queries``
    (train_detector.py:137-144): the reference re-uses checkpoints
    pre-trained with more queries by slicing the leading rows."""
    return {k: (v[:num_queries] if "query_embed" in k and getattr(v, "ndim", 0) == 2 else v)
            for k, v in state_dict.items()}


def main(argv=None):
    from grit_tpu_torch.config import Config, default_detection_config
    from grit_tpu_torch.detection.coco_eval import CocoEvaluator
    from grit_tpu_torch.detection.datasets import DetectionDataset, build_train_dataset
    from grit_tpu_torch.detection.det_transforms import make_transforms
    from grit_tpu_torch.detection.detector import build_detection_model
    from grit_tpu_torch.detection.hooks import (CheckpointHook, EpochLRHook, ProgressHook,
                                                ScalarWriterHook, TextLoggingHook)
    from grit_tpu_torch.detection.loader import DetectionLoader
    from grit_tpu_torch.detection.solver import (Trainer, Valider, detector_probe,
                                                 make_detector_train_step)
    from grit_tpu_torch.engine import checkpoint as ckpt
    from grit_tpu_torch.engine.optim import (build_detector_optimizer, frozen_mask,
                                             swin_frozen_stages_predicate)
    from grit_tpu_torch.engine.xe import TrainState
    from grit_tpu_torch.parallel.distributed import maybe_initialize, rank_device
    from grit_tpu_torch.parallel.mesh import wrap_data_parallel
    from grit_tpu_torch.utils.misc import seed_host_rngs

    config = default_detection_config().apply_overrides(
        list(sys.argv[1:] if argv is None else argv))
    device = torch.device(config.exp.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_detector: no CUDA device is available "
                           "(pass exp.device=cpu to run on the CPU)")
    device = rank_device(device)
    rank, world = maybe_initialize(device)
    workdir = os.path.join("outputs", config.exp.name)
    os.makedirs(workdir, exist_ok=True)

    # host-side augmentation RNGs, seed + rank (reference train_detector.py:116-120)
    seed_host_rngs(config.exp.seed, rank=rank)
    model, criterion = build_detection_model(config, device=device, seed=config.exp.seed)

    # ---- loader (reference train_detector.py:163-186) ----
    dataset = build_train_dataset(config)
    transform = make_transforms("train", scales=list(config.dataset.scales),
                                max_size=config.dataset.max_size)
    n_attr = (int(config.model.get("num_attr_classes", 0))
              if config.model.get("with_attributes") else 0)
    bucket = config.dataset.get("fixed_bucket", None)
    num_workers = int(config.optimizer.get("num_workers", 4))
    loader = DetectionLoader(
        dataset, config.optimizer.batch_size, transform=transform, mode="train",
        max_boxes=int(config.dataset.get("max_boxes", 100)), num_attr_classes=n_attr,
        bucket_hw=tuple(bucket) if bucket else None, rank=rank, world=world,
        seed=config.exp.seed, num_workers=num_workers)

    # ---- warm start (train_detector.py:134-153): weights only ----
    sp_names = list(config.optimizer.get("sp_names", []))
    if config.exp.get("checkpoint", ""):
        loaded = ckpt.restore_checkpoint_path(config.exp.checkpoint)
        loaded = loaded.get("state_dict", loaded)
        if any("query_embed" in s for s in sp_names):
            loaded = _trim_query_embed(loaded, int(config.model.detector.num_queries))
        miss, unexp = ckpt.load_params_flexible(model, loaded)
        print(f"loaded {config.exp.checkpoint}: missing {miss}, unexpected {unexp}")

    # ---- optimizer: 4 groups + sp (train_detector.py:24-89); frozen Swin
    # stages are in no group, so they get neither updates nor decay ----
    fs = int(config.model.get("frozen_stages", -1))
    freeze = frozen_mask(model, swin_frozen_stages_predicate(fs)) if fs >= 0 else None
    optimizer = build_detector_optimizer(
        model, lr=config.optimizer.lr, lr_backbone=config.optimizer.lr_backbone,
        sp_lr=float(config.optimizer.get("sp_lr", 0.0)),
        weight_decay=float(config.optimizer.weight_decay), sp_names=sp_names, freeze=freeze)
    # DDP over the optimizer's parameters that a training forward reaches
    train_model = wrap_data_parallel(
        model, device, trained=[p for g in optimizer.param_groups for p in g["params"]],
        probe=detector_probe(criterion, loader))
    state = TrainState(train_model, optimizer, global_steps=0,
                       generator=torch.Generator(device=device))
    step_fn = make_detector_train_step(criterion,
                                       clip_max_norm=config.optimizer.clip_max_norm)

    decay = float(config.optimizer.get("decay_rate",
                                       config.optimizer.get("lr_drop_factor", 0.1)))
    hooks = [
        # milestone m applies from 0-indexed epoch m - 1 (the pre-loop step quirk)
        EpochLRHook([m - 1 for m in config.optimizer.lr_drop_epochs], decay),
        EpochLRHook([m - 1 for m in config.optimizer.get("sp_lr_drop_epochs", [])],
                    decay, attr="sp_epoch_lr_scale"),
        ProgressHook(),
        TextLoggingHook(os.path.join(workdir, "detector_log.txt")),
        ScalarWriterHook(os.path.join(workdir, "scalars.jsonl")),
        CheckpointHook(workdir),
    ]

    # ---- validation: COCO-format val sets -> postprocess -> mAP evaluator ----
    validers = []
    for _, spec in config.dataset.get("valid_roots", Config({})).items():
        vds = DetectionDataset(spec["ann_file"], spec.get("img_root", ""))
        vloader = DetectionLoader(
            vds, max(1, config.optimizer.batch_size), mode="valid",
            transform=make_transforms("valid", max_size=config.dataset.max_size),
            rank=rank, world=world, num_workers=num_workers)
        gt = {int(i): {"boxes": np.asarray([[a["bbox"][0], a["bbox"][1],
                                             a["bbox"][0] + a["bbox"][2],
                                             a["bbox"][1] + a["bbox"][3]]
                                            for a in vds.anns_by_image[i]]),
                       "labels": np.asarray([a["category_id"] for a in vds.anns_by_image[i]])}
              for i in vds.ids[:len(vds)]}
        validers.append(Valider(lambda: trainer.state.model, vloader,
                                evaluator_factory=lambda gt=gt: CocoEvaluator(gt),
                                device=device))

    # the dropout masks: seed + rank, keyed by the epoch in run_epoch
    trainer = Trainer(step_fn, state, loader, device=device, seed=rank, hooks=hooks,
                      validers=validers)

    # ---- resume (exp.resume=true): the full state from 'detector_last' ----
    start_epoch = 0
    if config.exp.get("resume", False):
        try:
            restored = ckpt.restore_checkpoint(workdir, "detector_last")
        except FileNotFoundError as e:   # no checkpoint yet: a fresh run
            print(f"resume skipped: {e}")
        else:
            ckpt.load_train_state(trainer.state, restored)
            start_epoch = int(restored["epoch"]) + 1
            trainer.global_step = int(restored["global_steps"])
            print(f"resumed detector training from epoch {start_epoch - 1}")

    for epoch in range(start_epoch, config.optimizer.epochs):
        # epoch-keyed host augmentation RNGs: a resumed run's epoch E draws the
        # same flips, crops and scales as an uninterrupted run's epoch E
        seed_host_rngs(config.exp.seed + 7919 * (epoch + 1), rank=rank)
        loader.set_epoch(epoch)
        trainer.run_epoch(epoch)
    return trainer


if __name__ == "__main__":
    main()
