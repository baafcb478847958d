"""Optimizer and LR schedule for caption training.

Parity notes (reference engine/caption_engine.py:18-73, utils/cap_scheduler.py;
grit_tpu/engine/optim.py):

- TWO Adam groups split on whether the parameter name contains ``detector``
  ("backbone": Swin AND deformable decoder) or not ("model"); betas
  (0.9, 0.99).  The reference hands Adam a ``weight_decay_rate`` key that
  Adam ignores, so no weight decay is applied by default.
- The cosine schedule with a 1-epoch linear warm-up drives the **model**
  group only; the backbone group keeps a fixed LR.
- ``scheduler.step()`` runs once at epoch start AND once per iteration
  (caption_engine.py:325-326,348).  ``cosine_lr_schedule`` is a pure function
  of ``global_steps``; the training loop manages the counter
  (``xe.TrainState.epoch_tick``).
- The caption generator's ``pos_emb`` is never updated (``freeze=True`` in
  the reference), nor is any parameter the freeze predicate names
  (``requires_grad=False`` there).

The JAX package keeps Adam's moments LR-free and scales the update inside the
step; here ``torch.optim.Adam`` holds two parameter groups and the step sets
the model group's LR from the schedule before ``optimizer.step()``.  Frozen
parameters are in no group.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn


def split_param_labels(model: nn.Module) -> dict[str, str]:
    """name -> 'frozen' (the ``pos_emb`` table), 'backbone' (name contains
    ``detector``) or 'model'."""
    labels = {}
    for name, _ in model.named_parameters():
        if name.split(".")[-2:-1] == ["pos_emb"]:
            labels[name] = "frozen"
        else:
            labels[name] = "backbone" if "detector" in name else "model"
    return labels


def frozen_mask(model: nn.Module, frozen_predicate: Callable[[str], bool]) -> dict[str, bool]:
    """name -> True where ``frozen_predicate(name)`` holds (freezing by name,
    train_caption.py:48-57)."""
    return {name: bool(frozen_predicate(name)) for name, _ in model.named_parameters()}


def swin_frozen_stages_predicate(frozen_stages: int) -> Callable[[str], bool]:
    """Predicate on the port's parameter names for the reference's Swin stage
    freezing (swin_model.py:622-637 with coco_config.yaml:29): ``fs >= 0``
    freezes the patch embed, ``fs >= 2`` stages ``0 .. fs-2``, under the
    captioner's ``detector.backbone``."""

    def pred(name: str) -> bool:
        if "backbone" not in name:
            return False
        if frozen_stages >= 0 and "patch_embed" in name:
            return True
        return any(f".layers.{i}." in name for i in range(max(0, frozen_stages - 1)))

    return pred


def cosine_lr_schedule(global_steps: int, *, num_epochs: int, num_its_per_epoch: int,
                       init_lr: float, min_lr: float, warmup_init_lr: float,
                       warmup_factor: float = 0.1, warmup_epochs: int = 1) -> float:
    """CosineLRScheduler.step as a pure function (utils/cap_scheduler.py:28-59)."""
    gs = float(global_steps)
    if int(global_steps) // num_its_per_epoch < 1:
        alpha = gs / num_its_per_epoch / warmup_epochs
        return ((init_lr - warmup_init_lr) * (warmup_factor * (1.0 - alpha) + alpha)
                + warmup_init_lr)
    total = num_epochs * num_its_per_epoch
    return max(min_lr, (init_lr - min_lr) * (1 + math.cos(math.pi * gs / total)) / 2 + min_lr)


def build_optimizer(model: nn.Module, *, model_lr: float, backbone_lr: float,
                    beta_1: float = 0.9, beta_2: float = 0.99, weight_decay: float = 0.0,
                    freeze: Optional[dict[str, bool]] = None) -> torch.optim.Adam:
    """Adam over two groups, ``param_groups[0]`` the model group (its LR is
    set each step from the schedule) and ``param_groups[1]`` the backbone
    group (fixed LR).  Parameters labelled frozen, or named by ``freeze``, are
    left out."""
    labels = split_param_labels(model)
    groups = {"model": [], "backbone": []}
    for name, p in model.named_parameters():
        if labels[name] != "frozen" and not (freeze and freeze[name]):
            groups[labels[name]].append(p)
    return torch.optim.Adam(
        [{"params": groups["model"], "lr": model_lr, "name": "model"},
         {"params": groups["backbone"], "lr": backbone_lr, "name": "backbone"}],
        betas=(beta_1, beta_2), eps=1e-8, weight_decay=weight_decay)
