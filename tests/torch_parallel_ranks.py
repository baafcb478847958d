"""Rank bodies for tests/test_torch_parallel.py, started by
``grit_tpu_torch.parallel.distributed.run_ranks`` in fresh processes (gloo on
the CPU).  This module imports no JAX: the ranks must stay free of it.  Each
body takes what the test built (models travel pickled, on the CPU) and
returns plain values or CPU tensors."""

from __future__ import annotations

import os

import torch

from grit_tpu_torch.detection.coco_eval import CocoEvaluator
from grit_tpu_torch.detection.losses import SetCriterion
from grit_tpu_torch.detection.solver import detector_probe, make_detector_train_step
from grit_tpu_torch.engine import optim
from grit_tpu_torch.engine.evaluator import evaluate_splits, make_caption_generator
from grit_tpu_torch.engine.scst import make_scst_update_step
from grit_tpu_torch.engine.xe import (TrainState, make_eval_loss_step, make_xe_train_step,
                                      xe_probe)
from grit_tpu_torch.parallel.distributed import allgather_pyobj, rank, world_size
from grit_tpu_torch.parallel.mesh import global_sum, shard_batch, wrap_data_parallel


def _trained(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def _leaves(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _grads(model) -> dict:
    return {n: None if p.grad is None else p.grad.clone() for n, p in model.named_parameters()}


def xe_step(model, batch, *, sched, backbone_lr, frozen_stages, pad, bos):
    """The validation loss of the initial weights and one XE step on this
    rank's share of ``batch`` (its rows padded as the loaders pad them)."""
    freeze = optim.frozen_mask(model, optim.swin_frozen_stages_predicate(frozen_stages))
    opt = optim.build_optimizer(model, model_lr=sched["init_lr"], backbone_lr=backbone_lr,
                                freeze=freeze)
    mine = shard_batch(batch, int_fill=pad, int_first=bos)
    val = float(make_eval_loss_step(model, pad_idx=pad)(mine))
    dp = wrap_data_parallel(model, "cpu", trained=_trained(opt),
                            probe=xe_probe([mine], pad_idx=pad))
    state = TrainState(dp, opt, global_steps=1, generator=torch.Generator().manual_seed(rank()))
    state, metrics = make_xe_train_step(pad_idx=pad, sched_cfg=sched)(state, mine)
    return {"loss": float(global_sum(metrics["loss"])), "val_loss": val, "lr": metrics["lr"],
            "rows": int(mine["captions"].shape[0]), "params": _leaves(model),
            "grads": _grads(model), "ddp": type(dp).__name__}


def scst_step(model, samples, sequences, rewards, n_valid, *, model_lr, backbone_lr,
              frozen_stages, pad, bos, eos):
    """One SCST update on this rank's images (rank r: rows r, r + world, ...),
    with its own count of real images."""
    freeze = optim.frozen_mask(model, optim.swin_frozen_stages_predicate(frozen_stages))
    opt = optim.build_optimizer(model, model_lr=model_lr, backbone_lr=backbone_lr,
                                freeze=freeze)
    r, w = rank(), world_size()
    mine = shard_batch({"samples": samples, "sequences": sequences, "rewards": rewards})
    n_mine = len(range(r, n_valid, w))
    probe_caps = torch.cat([torch.full((1, 1), bos), mine["sequences"][:1, 0]], 1)
    dp = wrap_data_parallel(model, "cpu", trained=_trained(opt), probe=xe_probe(
        [{"samples": mine["samples"], "captions": probe_caps}], pad_idx=pad))
    state = TrainState(dp, opt, global_steps=0, generator=torch.Generator().manual_seed(r))
    step = make_scst_update_step(bos_idx=bos, eos_idx=eos, model_lr=model_lr,
                                 backbone_lr=backbone_lr)
    state, metrics = step(state, mine["samples"], mine["sequences"],
                          mine["rewards"].numpy(), n_mine)
    return {"metrics": {k: float(global_sum(v)) for k, v in metrics.items()},
            "params": _leaves(model), "grads": _grads(model)}


def detector_step(model, batch, *, num_classes, hyper, sp_names, clip, lr_scales):
    """One detector step on this rank's images, the host matching per image."""
    crit = SetCriterion(num_classes)
    opt = optim.build_detector_optimizer(model, sp_names=sp_names, **hyper)
    mine = shard_batch(batch)
    dp = wrap_data_parallel(model, "cpu", trained=_trained(opt),
                            probe=detector_probe(crit, [mine]))
    state = TrainState(dp, opt, global_steps=0, generator=torch.Generator().manual_seed(rank()))
    state, metrics = make_detector_train_step(crit, clip_max_norm=clip)(
        state, mine["samples"], mine["targets"], *lr_scales)
    return {"loss": float(global_sum(metrics["loss"])), "grad_norm": float(metrics["grad_norm"]),
            "params": _leaves(model),
            "off_path": sorted(n for n, p in model.named_parameters() if not p.requires_grad)}


def exchange(gt: dict, preds: dict, model, loaders: dict, vocab_words: list):
    """``allgather_pyobj`` of a per-rank object; the COCO evaluator over this
    rank's shard of ``preds``, merged; the rank-specialised caption
    evaluation of ``loaders`` ({split: list of batches})."""
    from collections import Counter

    from grit_tpu_torch.data.field import TextField
    from grit_tpu_torch.data.vocab import Vocab

    r, w = rank(), world_size()
    gathered = allgather_pyobj({"rank": r, "payload": list(range(r + 1))})
    ev = CocoEvaluator(gt)
    ids = sorted(preds)[r::w]
    ev.update(ids, [preds[i] for i in ids])
    held = len(ev.preds)
    ev.synchronize_between_processes()
    text_field = TextField(vocab=Vocab(counter=Counter({t: 5 for t in vocab_words})),
                           eos_token="<off>")
    model.eval()
    generate = make_caption_generator(model, beam_size=2, max_len=5, bos_idx=2, eos_idx=3)
    scores = evaluate_splits(generate, loaders, text_field, device="cpu")
    return {"gathered": gathered, "held": held, "merged": sorted(ev.preds),
            "summary": ev.summarize(), "scores": scores}


def train_caption_cli(workdir: str, argv: list) -> dict:
    """``train_caption.main`` in ``workdir`` (DATA_ROOT comes with the
    environment)."""
    from grit_tpu_torch.train_caption import main

    os.chdir(workdir)
    state = main(argv)
    return {"ddp": type(state.model).__name__, "steps": state.global_steps,
            "params": {n: float(p.detach().double().sum())
                       for n, p in state.model.module.named_parameters()}}


def run_all(calls: list) -> list:
    """Several bodies in one start of the ranks: ``[(name, args, kwargs),
    ...]`` -> their results, in order."""
    return [globals()[name](*args, **kwargs) for name, args, kwargs in calls]
