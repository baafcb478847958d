"""Hook system for the detector solver.

Protocol parity: reference engine/hooks.py:12-31 — hooks implement any of
``before_epoch / after_epoch / before_step / after_step`` and are executed
by the solver in registration order.

Provided hooks mirror the reference set:
- CheckpointHook: every-N-epochs saves + top-k-by-metric retention (:34-106);
- TextLoggingHook (:109-124), TensorboardHook (:127-156, tensorboardX-free
  fallback writes scalars to a jsonl), ProgressHook (:193-213);
- WarmupLRHook / EpochLRHook (:159-190): per-step linear warmup and
  per-epoch MultiStep decay, applied by mutating the solver's lr scale.

Under data parallel every rank runs every hook (the logging hooks reduce the
metrics over the ranks when they read them), and rank 0 alone writes files
and prints.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from grit_tpu_torch.parallel.distributed import is_main_process


class Hook:
    def before_epoch(self, solver):
        pass

    def after_epoch(self, solver):
        pass

    def before_step(self, solver):
        pass

    def after_step(self, solver):
        pass


class CheckpointHook(Hook):
    def __init__(self, workdir: str, every: int = 1, topk: int = 3,
                 metric: str = "mAP"):
        self.workdir = workdir
        self.every = every
        self.topk = topk
        self.metric = metric
        self.saved: list[tuple[float, str]] = []

    def after_epoch(self, solver):
        from grit_tpu_torch.engine import checkpoint as ckpt

        if (solver.epoch + 1) % self.every != 0:
            return
        name = f"detector_epoch_{solver.epoch}"
        ckpt.save_checkpoint(
            self.workdir, name, state=solver.state, epoch=solver.epoch
        )
        ckpt.save_checkpoint(
            self.workdir, "detector_last", state=solver.state, epoch=solver.epoch
        )
        score = float(solver.epoch_results.get(self.metric, 0.0))
        self.saved.append((score, name))
        self.saved.sort(reverse=True)
        # prune beyond top-k (reference hooks.py:91-99)
        for _, old in self.saved[self.topk:]:
            path = os.path.join(self.workdir, "checkpoints", old)
            if is_main_process() and os.path.isdir(path):
                import shutil

                shutil.rmtree(path, ignore_errors=True)
        self.saved = self.saved[: self.topk]


class TextLoggingHook(Hook):
    def __init__(self, path: str = "detector_log.txt", every: int = 50):
        self.path = path
        self.every = every

    def after_step(self, solver):
        if solver.step_in_epoch % self.every == 0:
            metrics = solver.read_metrics()
            if not is_main_process():
                return
            msg = (f"epoch {solver.epoch} it {solver.step_in_epoch}: "
                   + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            with open(self.path, "a") as f:
                f.write(msg + "\n")
            print(msg)

    def after_epoch(self, solver):
        if is_main_process():
            with open(self.path, "a") as f:
                f.write(f"epoch {solver.epoch} results: {solver.epoch_results}\n")


class ScalarWriterHook(Hook):
    """Tensorboard-style scalar logging to scalars.jsonl (no tbX dependency)."""

    def __init__(self, path: str = "scalars.jsonl", every: int = 20):
        self.path = path
        self.every = every

    def after_step(self, solver):
        if solver.step_in_epoch % self.every == 0:
            rec = {"step": solver.global_step, "epoch": solver.epoch}
            rec.update(solver.read_metrics())
            if not is_main_process():
                return
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")


class ProgressHook(Hook):
    def __init__(self, every: int = 50):
        self.every = every
        self._t0 = None

    def before_epoch(self, solver):
        self._t0 = time.time()

    def after_step(self, solver):
        if (solver.step_in_epoch % self.every == 0 and solver.step_in_epoch > 0
                and is_main_process()):
            rate = solver.step_in_epoch / (time.time() - self._t0)
            print(f"epoch {solver.epoch}: {solver.step_in_epoch}/{solver.steps_per_epoch} "
                  f"({rate:.2f} it/s)")


class WarmupLRHook(Hook):
    """Linear warmup over the first N steps (reference hooks.py:159-175)."""

    def __init__(self, warmup_steps: int = 500, warmup_factor: float = 1e-3):
        self.warmup_steps = warmup_steps
        self.warmup_factor = warmup_factor

    def before_step(self, solver):
        if solver.global_step < self.warmup_steps:
            alpha = solver.global_step / self.warmup_steps
            solver.lr_scale = self.warmup_factor * (1 - alpha) + alpha
        else:
            solver.lr_scale = 1.0


class EpochLRHook(Hook):
    """MultiStepLR: decay by factor at given epochs (train_detector.py:24-89).

    ``attr`` selects which solver scale this schedule drives:
    ``epoch_lr_scale`` (the main 4-group optimizer, lr_drop_epochs) or
    ``sp_epoch_lr_scale`` (the sp optimizer, sp_lr_drop_epochs).

    Tick parity note: the reference steps every scheduler once BEFORE the
    epoch loop (train_detector.py:245-246), so torch's MultiStepLR first
    applies a milestone ``m`` during 0-indexed epoch ``m - 1``.  The CLI
    passes ``[m - 1 for m in lr_drop_epochs]`` to reproduce that; this hook
    itself drops at ``epoch >= e`` exactly.
    """

    def __init__(self, drop_epochs: list[int], factor: float = 0.1,
                 attr: str = "epoch_lr_scale"):
        self.drop_epochs = sorted(drop_epochs)
        self.factor = factor
        self.attr = attr

    def before_epoch(self, solver):
        n_drops = sum(1 for e in self.drop_epochs if solver.epoch >= e)
        setattr(solver, self.attr, self.factor ** n_drops)
