"""Caption training CLI: the 4-phase XE -> SCST schedule on one GPU.

Reference parity: train_caption.py (phase machine :95-113, freeze logic
:48-59, SC warm-start from best-valid :131-133, per-phase checkpoints
:181-202); grit_tpu's train_caption.py, whose overrides it takes.

Usage:
  python -m grit_tpu_torch.train_caption exp.name=run1 optimizer.finetune_xe_epochs=10 ...
  (dotted overrides; config defaults mirror configs/caption/coco_config.yaml)

``exp.device`` (or ``--device``) defaults to ``cuda``, and the CLI raises
without a card; ``exp.device=cpu`` runs on the CPU.  On either device the
model computes in ``model.compute_dtype``: fp32 by default, as the config
that grit_tpu's CLI reads; ``model.compute_dtype=bfloat16`` computes in bf16
over f32 master parameters.

The freezing mode (``optimizer.freezing_xe_epochs`` > 0 without
``freeze_backbone``) trains on pre-extracted detector features; where
``dataset.hdf5_path`` is absent, the CLI first extracts them with the loaded
detector weights, in the compute dtype, through
``tools/extract_features.py`` (grit_tpu's train_caption.py:115-142).

Data parallel: one process a card, started by ``torchrun``,

  torchrun --nproc_per_node N -m grit_tpu_torch.train_caption exp.name=run1 ...

(``parallel.distributed.maybe_initialize``: NCCL between cards, gloo on the
CPU).  ``optimizer.batch_size`` is per rank, as the reference's per-GPU batch;
the loaders deal each rank its share of every global batch, the model trains
under ``DistributedDataParallel``, and the loss and updates are the global
batch's.  The freezing mode's feature extraction runs on rank 0 while the
others wait; the evaluation is rank-specialised (valid on rank 0, test on
rank 1, the scores exchanged); rank 0 writes ``result.csv``, the logs and the
checkpoints.
"""

from __future__ import annotations

import os
import sys

import torch

from grit_tpu_torch.eval_caption import compute_dtype as _compute_dtype


def main(argv=None):
    from grit_tpu_torch.convert import load_reference_checkpoint
    from grit_tpu_torch.data.coco import build_coco_dataloaders
    from grit_tpu_torch.data.field import TextField
    from grit_tpu_torch.data.metrics import Cider, PTBTokenizer
    from grit_tpu_torch.engine import checkpoint as ckpt
    from grit_tpu_torch.engine.evaluator import evaluate_splits, make_caption_generator
    from grit_tpu_torch.engine.logger import ScalarWriter
    from grit_tpu_torch.engine.loops import (log_epoch_csv, phase_for_epoch, total_epochs,
                                             train_sc_epoch, train_xe_epoch)
    from grit_tpu_torch.engine.optim import (build_optimizer, frozen_mask,
                                             swin_frozen_stages_predicate)
    from grit_tpu_torch.engine.scst import make_generate_step, make_scst_update_step
    from grit_tpu_torch.engine.xe import (TrainState, make_eval_loss_step, make_xe_train_step,
                                          xe_probe)
    from grit_tpu_torch.eval_caption import caption_config, config_device
    from grit_tpu_torch.models.captioner import build_captioner, build_detector
    from grit_tpu_torch.parallel.distributed import barrier, maybe_initialize
    from grit_tpu_torch.parallel.mesh import wrap_data_parallel
    from grit_tpu_torch.tools.extract_features import extract_vis_features
    from grit_tpu_torch.utils.misc import seed_host_rngs

    config = caption_config(sys.argv[1:] if argv is None else argv)
    device = config_device(config, "train_caption")
    rank, world = maybe_initialize(device)
    workdir = os.path.join("outputs", config.exp.name)
    os.makedirs(workdir, exist_ok=True)

    # host-side augmentation RNGs, seed + rank (reference train_caption.py:30-32)
    seed_host_rngs(config.exp.seed, rank=rank)

    model = build_captioner(config, device=device, dtype=_compute_dtype(config),
                            seed=config.exp.seed, train=True)
    text_field = TextField(vocab_path=config.dataset.vocab_path)

    # pretrained detector weights (reference train_caption.py:38-39)
    det_ckpt = config.model.detector.checkpoint
    if det_ckpt and os.path.exists(det_ckpt):
        miss, unexp = ckpt.load_params_flexible(model.detector,
                                                load_reference_checkpoint(det_ckpt))
        print(f"Loading weights for detector: missing: {miss}, unexpected: {unexp}.")

    # freezing (train_caption.py:48-57): substring rules on parameter names,
    # plus the backbone's frozen_stages (swin_model.py:622-637 via
    # coco_config.yaml:29), which applies in every phase
    preds = []
    if config.optimizer.get("freeze_backbone"):
        preds.append(lambda p: "backbone" in p)
    if config.optimizer.get("freeze_detector"):
        preds.append(lambda p: "detector" in p)
    fs = int(config.model.get("frozen_stages", -1))
    if fs >= 0:
        preds.append(swin_frozen_stages_predicate(fs))
    freeze = frozen_mask(model, lambda p: any(f(p) for f in preds)) if preds else None

    optimizer = build_optimizer(
        model, model_lr=config.optimizer.xe_lr, backbone_lr=config.optimizer.xe_backbone_lr,
        beta_1=config.optimizer.beta_1, beta_2=config.optimizer.beta_2, freeze=freeze)

    mode = ("freezing" if config.optimizer.freezing_xe_epochs > 0
            and not config.optimizer.get("freeze_backbone") else "finetune")
    if mode == "freezing" and not os.path.exists(config.dataset.hdf5_path):
        # train on pre-extracted features (reference train_caption.py:48-59):
        # rank 0 extracts them now, with the loaded detector weights, over the
        # whole dataset (every rank reads it); the others wait
        if rank == 0:
            print(f"{config.dataset.hdf5_path} absent -> extracting features")
            detector = build_detector(config, device=device, dtype=_compute_dtype(config),
                                      seed=None)
            detector.load_state_dict(model.detector.state_dict())
            extract_loaders, _ = build_coco_dataloaders(config, mode="finetune", rank=0, world=1)
            extract_vis_features(detector, extract_loaders, device, config.dataset.hdf5_path)
            del detector
        barrier("auto_extract_features")

    dataloaders, _ = build_coco_dataloaders(config, mode=mode, rank=rank, world=world)
    # DDP over what this run trains: the optimizer's parameters that one
    # training forward reaches (the freezing mode's reaches no detector)
    train_model = wrap_data_parallel(
        model, device, trained=[p for g in optimizer.param_groups for p in g["params"]],
        probe=xe_probe(dataloaders["train"], pad_idx=config.model.pad_idx))
    # each rank draws its own dropout masks
    state = TrainState(train_model, optimizer, global_steps=0,
                       generator=torch.Generator(device=device).manual_seed(config.exp.seed + rank))
    train_refs = [ex.text for ex in dataloaders["train"].dataset.examples]
    cider = Cider(PTBTokenizer.tokenize(train_refs))

    m, o = config.model, config.optimizer
    sched_cfg = dict(num_epochs=o.freezing_xe_epochs + o.finetune_xe_epochs,
                     num_its_per_epoch=max(1, len(dataloaders["train"])),
                     init_lr=o.xe_lr, min_lr=o.min_lr, warmup_init_lr=o.warmup_init_lr)
    xe_step = make_xe_train_step(pad_idx=m.pad_idx, sched_cfg=sched_cfg,
                                 backbone_lr=o.xe_backbone_lr)
    eval_loss_step = make_eval_loss_step(model, pad_idx=m.pad_idx)
    beam = dict(beam_size=m.beam_size, max_len=m.beam_len, bos_idx=m.bos_idx, eos_idx=m.eos_idx)
    generate_eval = make_caption_generator(model, **beam)
    generate_sc = make_generate_step(model, **beam)
    scst_update = make_scst_update_step(bos_idx=m.bos_idx, eos_idx=m.eos_idx, model_lr=o.sc_lr,
                                        backbone_lr=o.sc_backbone_lr)

    writer = ScalarWriter(os.path.join(workdir, "tensorboard")) if rank == 0 else None
    best_cider_val = best_cider_test = 0.0
    sc_started = False
    start_epoch = 0
    if config.exp.resume:
        # full resume from 'last': parameters, optimizer, scheduler tick, epoch,
        # best CIDErs and the dropout generator
        try:
            restored = ckpt.restore_checkpoint(workdir, "last")
            ckpt.load_train_state(state, restored)
            start_epoch = int(restored["epoch"]) + 1
            best_cider_val, best_cider_test = (float(x) for x in restored["best_ciders"])
            # resuming INSIDE the SC phase must not warm-start again from
            # best_valid (that would clobber the resumed parameters); only a
            # resume at the XE->SC boundary still warm-starts
            sc_started = start_epoch > 0 and phase_for_epoch(
                start_epoch - 1, config).endswith("sc")
            print(f"resumed from epoch {start_epoch - 1}")
        except FileNotFoundError as e:
            print(f"resume skipped: {e}")

    for epoch in range(start_epoch, total_epochs(config)):
        phase = phase_for_epoch(epoch, config)
        print(f"Train: epoch={epoch}, phase={phase}")
        if phase.endswith("xe"):
            state, train_res = train_xe_epoch(
                xe_step, eval_loss_step, state, dataloaders, epoch=epoch, device=device,
                writer=writer, pad_idx=m.pad_idx, bos_idx=m.bos_idx)
        else:
            if not sc_started:
                # SC warm-start from best-valid (train_caption.py:131-133)
                try:
                    ckpt.load_train_state(state, ckpt.restore_checkpoint(workdir, "best_valid"),
                                          params_only=True)
                    print("Start self-critical optimization from best_valid")
                except FileNotFoundError as e:
                    print(f"best_valid restore skipped: {e}")
                sc_started = True
            state, train_res = train_sc_epoch(
                generate_sc, scst_update, eval_loss_step, state, dataloaders, cider, text_field,
                beam_size=m.beam_size, epoch=epoch, device=device, pad_idx=m.pad_idx,
                bos_idx=m.bos_idx)
        dataloaders["train"].set_epoch(epoch)
        dataloaders["train_dict"].set_epoch(epoch)

        model.eval()   # deterministic beam search (the decode tail goes through K11)
        # valid on rank 0 and test on rank 1 when there are two ranks or more
        scores_by_split = evaluate_splits(
            generate_eval, {"valid": dataloaders["valid_dict"], "test": dataloaders["test_dict"]},
            text_field, device=device, epoch=epoch)
        for split, scores in scores_by_split.items():
            if rank == 0:
                log_epoch_csv(config, epoch, split, scores, train_res, phase,
                              path=os.path.join(workdir, "result.csv"))
            best = best_cider_val if split == "valid" else best_cider_test
            if scores["CIDEr"] >= best:
                ckpt.save_checkpoint(workdir, f"best_{split}", state=state, epoch=epoch,
                                     best_ciders=(scores["CIDEr"], 0.0), config=config)
                if split == "valid":
                    best_cider_val = scores["CIDEr"]
                else:
                    best_cider_test = scores["CIDEr"]

        ckpt.save_checkpoint(workdir, phase, state=state, epoch=epoch, config=config)
        ckpt.save_checkpoint(workdir, "last", state=state, epoch=epoch,
                             best_ciders=(best_cider_val, best_cider_test), config=config)
        if epoch >= 15:
            ckpt.save_checkpoint(workdir, f"epoch_{epoch}", state=state, epoch=epoch,
                                 config=config)
    return state


if __name__ == "__main__":
    main()
