"""Cross-entropy (XE) caption training step.

Parity: reference engine/caption_engine.py:312-385; grit_tpu/engine/xe.py.

- loss = NLL of shifted targets with pad ignored: ``out[:, :-1]`` scored
  against ``captions[:, 1:]``, mean over non-pad tokens;
- cosine LR (model group) evaluated from the scheduler tick counter; the
  loop calls ``epoch_tick`` once per epoch to reproduce the reference's extra
  epoch-start ``scheduler.step()``;
- the backbone group keeps a fixed LR; frozen parameters are in no group.

One step: forward in ``train()`` mode (dropout and drop-path drawn from the
state's generator), backward, Adam update.  The model keeps f32 parameters
and computes in its compute dtype (``models.captioner.build_captioner(...,
train=True)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from grit_tpu_torch.engine.optim import cosine_lr_schedule


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    global_steps: int = 0      # scheduler tick counter (reference semantics)
    generator: Optional[torch.Generator] = None

    def epoch_tick(self) -> "TrainState":
        """The reference's extra scheduler.step() at epoch start."""
        self.global_steps += 1
        return self


def nll_loss(log_probs: torch.Tensor, captions: torch.Tensor, pad_idx: int):
    """Shifted NLL with pad ignored -> (loss, token_count)."""
    logp = log_probs[:, :-1]
    tgt = captions[:, 1:]
    ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = (tgt != pad_idx).to(ll.dtype)
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0), mask.sum()


def make_xe_train_step(*, pad_idx: int, sched_cfg: dict) -> Callable:
    """-> step(state, batch) -> (state, metrics): one XE update in place.

    batch: {'samples': ImageBatch on the model's device, 'captions': int
    [B, L]}.  metrics: {'loss': 0-d tensor (not synchronised), 'lr': float}.
    """

    def step(state: TrainState, batch):
        model = state.model
        model.train()
        model.set_generator(state.generator)
        lr = cosine_lr_schedule(state.global_steps, **sched_cfg)
        state.optimizer.param_groups[0]["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        out = model(batch["samples"], batch["captions"])
        loss, _ = nll_loss(out, batch["captions"], pad_idx)
        loss.backward()
        state.optimizer.step()
        state.global_steps += 1
        return state, {"loss": loss.detach(), "lr": lr}

    return step


def make_eval_loss_step(model, *, pad_idx: int) -> Callable:
    """Validation loss in ``eval()`` mode (caption_engine.py:287-309)."""

    @torch.no_grad()
    def step(batch) -> torch.Tensor:
        model.eval()
        out = model(batch["samples"], batch["captions"])
        return nll_loss(out, batch["captions"], pad_idx)[0]

    return step
