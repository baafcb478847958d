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

Data parallel (``parallel.mesh``): ``state.model`` is the rank's
``DistributedDataParallel``; the loss is the token mean over the GLOBAL batch,
as grit_tpu's under GSPMD.  Each rank backpropagates its masked NLL sum times
world over the global token count, so DDP's mean of the ranks' gradients is
the global batch's; a per-rank token mean would weight the ranks wrongly
whenever their token counts differ (a ragged tail).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from grit_tpu_torch.engine.optim import cosine_lr_schedule
from grit_tpu_torch.parallel.distributed import world_size
from grit_tpu_torch.parallel.mesh import global_sum, unwrap
from grit_tpu_torch.utils.nested import first_rows, to_device


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


def nll_sum(log_probs: torch.Tensor, captions: torch.Tensor, pad_idx: int):
    """Shifted NLL summed over the non-pad tokens -> (sum, token_count)."""
    logp = log_probs[:, :-1]
    tgt = captions[:, 1:]
    ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = (tgt != pad_idx).to(ll.dtype)
    return -(ll * mask).sum(), mask.sum()


def nll_loss(log_probs: torch.Tensor, captions: torch.Tensor, pad_idx: int):
    """Shifted NLL with pad ignored -> (loss, token_count)."""
    total, count = nll_sum(log_probs, captions, pad_idx)
    return total / count.clamp(min=1.0), count


def make_xe_train_step(*, pad_idx: int, sched_cfg: dict,
                       backbone_lr: Optional[float] = None) -> Callable:
    """-> step(state, batch) -> (state, metrics): one XE update in place.
    ``backbone_lr`` resets the backbone group's fixed LR at every step (an XE
    phase may follow an SC phase, which sets its own); None leaves it as built.

    batch: {'samples': ImageBatch on the model's device, 'captions': int
    [B, L]}, the rank's share of the global batch.  metrics: {'loss': 0-d
    tensor, this rank's share of the global batch's loss (the loss on one
    rank; ``parallel.mesh.global_sum`` of it on every rank), not
    synchronised, 'lr': float}.
    """

    def step(state: TrainState, batch):
        model = state.model
        model.train()
        unwrap(model).set_generator(state.generator)
        lr = cosine_lr_schedule(state.global_steps, **sched_cfg)
        state.optimizer.param_groups[0]["lr"] = lr
        if backbone_lr is not None:
            state.optimizer.param_groups[1]["lr"] = backbone_lr
        state.optimizer.zero_grad(set_to_none=True)
        total, count = nll_sum(model(batch["samples"], batch["captions"]), batch["captions"],
                               pad_idx)
        # this rank's share of the global batch's token mean
        share = total / global_sum(count).clamp(min=1.0)
        (share * world_size()).backward()    # DDP averages over the ranks
        state.optimizer.step()
        state.global_steps += 1
        return state, {"loss": share.detach(), "lr": lr}

    return step


def xe_probe(batches, *, pad_idx: int) -> Callable:
    """-> probe(model): the NLL of one teacher-forced forward in ``train()``
    on the first row of the first batch of ``batches`` (a loader; read only
    when the probe runs), its dropout masks drawn from a generator of its
    own: what ``parallel.mesh.wrap_data_parallel`` backpropagates to find the
    parameters that an XE or SCST step leaves without a gradient (both run
    the same forward)."""
    def probe(model):
        device = next(model.parameters()).device
        model.train()
        model.set_generator(torch.Generator(device=device).manual_seed(0))
        row = to_device(first_rows(next(iter(batches)), 1), device)
        return nll_loss(model(row["samples"], row["captions"]), row["captions"], pad_idx)[0]

    return probe


def make_eval_loss_step(model, *, pad_idx: int) -> Callable:
    """Validation loss in ``eval()`` mode (caption_engine.py:287-309) of the
    rank's local ``model`` (not its DDP wrapper): the global batch's token
    mean, one all-reduce of (sum, count) a batch.  ``batch`` None: a rank's
    empty share of the last batch, which adds nothing and still joins the
    all-reduce."""

    @torch.no_grad()
    def step(batch) -> torch.Tensor:
        model.eval()
        if batch is None:
            total = count = torch.zeros((), device=next(model.parameters()).device)
        else:
            out = model(batch["samples"], batch["captions"])
            total, count = nll_sum(out, batch["captions"], pad_idx)
        if world_size() > 1:
            total, count = global_sum(torch.stack([total, count]))
        return total / count.clamp(min=1.0)

    return step
