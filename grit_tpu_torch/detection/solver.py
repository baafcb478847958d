"""Detector training/validation solver with hooks.

Parity: reference engine/solver.py:11-102 (SolverBase epoch/step skeleton),
engine/det_solver.py (Trainer.on_step :56-125: forward, criterion, weighted
sum, grad clip, multi-group step, logging; Valider.run_epoch :230-273:
postprocess -> CocoEvaluator -> mAP summary); grit_tpu/detection/solver.py.

A step runs eagerly: forward, the criterion (the Hungarian assignments of
every prediction level in one ``grit_lsa`` launch on the card, or one round
trip to the host under ``match_impl="host"``), backward, a global-norm
clip in plain torch, and the five-group ``Adam`` step through K12.  Hooks
drive the learning rates through the solver's scales.

Data parallel: ``state.model`` is the rank's ``DistributedDataParallel``; the
criterion normalises by the global box count, each rank backpropagates its
share of the loss times world, and the clip reads the gradients after DDP's
all-reduce, so every rank clips the same global norm.  The logged metrics are
summed (the losses, which are shares) or averaged (the others) over the ranks
where a hook reads them (``SolverBase.read_metrics``).  The ``Valider``
evaluates the rank's shard of the validation set on the local model and
merges the predictions through ``CocoEvaluator.synchronize_between_processes``.
"""

from __future__ import annotations

from typing import Callable

import torch

from grit_tpu_torch.detection.postprocess import postprocess
from grit_tpu_torch.engine.optim import apply_detector_lr
from grit_tpu_torch.engine.xe import TrainState
from grit_tpu_torch.models.layers import set_generator
from grit_tpu_torch.parallel.distributed import world_size
from grit_tpu_torch.parallel.mesh import global_sum, unwrap
from grit_tpu_torch.utils.misc import trace_annotation
from grit_tpu_torch.utils.nested import first_rows, to_device


def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place so that their global L2 norm is at most
    ``max_norm`` (no-op when it is 0) -> the norm before clipping.  The scale
    is min(1, max_norm / (norm + 1e-6)), as the JAX package's step and
    ``torch.nn.utils.clip_grad_norm_`` compute it."""
    grads = [p.grad for p in params if p.grad is not None]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if max_norm:
        torch._foreach_mul_(grads, (max_norm / (gnorm + 1e-6)).clamp(max=1.0))
    return gnorm


def make_detector_train_step(criterion, *, clip_max_norm: float = 0.1) -> Callable:
    """-> step(state, images, targets, lr_scale, sp_lr_scale) -> (state,
    metrics): one detector update in place.

    ``state``: an ``engine.xe.TrainState`` whose optimizer comes from
    ``build_detector_optimizer``; ``images``: an ``ImageBatch`` and
    ``targets``: the padded target tensors, on the model's device.
    ``lr_scale`` multiplies the four main groups' base rates (warm-up and the
    MultiStepLR over lr_drop_epochs), ``sp_lr_scale`` the sp group's
    (sp_lr_drop_epochs; reference train_detector.py:75-89).  ``assigns``
    [levels, B, G] replaces the Hungarian matching (comparisons of two
    arithmetic paths feed both one assignment).  metrics: the
    total ``loss``, ``grad_norm`` and the last level's named losses, 0-d
    tensors that are not synchronised; the losses are this rank's shares of
    the global batch's (the losses on one rank)."""

    def step(state: TrainState, images, targets, lr_scale: float = 1.0,
             sp_lr_scale: float = 1.0, assigns=None):
        model, optimizer = state.model, state.optimizer
        model.train()
        set_generator(unwrap(model), state.generator)
        apply_detector_lr(optimizer, lr_scale, sp_lr_scale)
        optimizer.zero_grad(set_to_none=True)
        with trace_annotation("grit.forward"):
            outputs = model(images, training=True)
        with trace_annotation("grit.criterion"):
            losses = criterion(outputs, targets, assigns=assigns)
            total = criterion.total_loss(losses)
        with trace_annotation("grit.backward"):
            (total * world_size()).backward()     # DDP averages over the ranks
        with trace_annotation("grit.optimizer"):
            params = [p for g in optimizer.param_groups for p in g["params"]]
            for p in params:
                # a parameter off the path (``level_embed``) still decays, as
                # with the JAX package's structurally complete gradients
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            gnorm = clip_grad_norm(params, clip_max_norm)
            optimizer.step()
        state.global_steps += 1
        metrics = {"loss": total.detach(), "grad_norm": gnorm}
        metrics.update({k: v.detach() for k, v in losses.items() if not k[-1].isdigit()})
        return state, metrics

    return step


def detector_probe(criterion, batches) -> Callable:
    """-> probe(model): the total loss of one training forward on the first
    image of the first batch of ``batches`` (read when the probe runs), its
    dropout masks from a generator of its own: what
    ``parallel.mesh.wrap_data_parallel`` backpropagates to find the
    parameters a detector step leaves without a gradient."""
    def probe(model):
        device = next(model.parameters()).device
        model.train()
        set_generator(model, torch.Generator(device=device).manual_seed(0))
        batch = to_device(first_rows(next(iter(batches)), 1), device)
        return criterion.total_loss(criterion(model(batch["samples"], training=True),
                                              batch["targets"]))

    return probe


class SolverBase:
    """Epoch/step skeleton executing hooks (reference solver.py:11-102)."""

    def __init__(self, hooks=()):
        self.hooks = list(hooks)
        self.epoch = 0
        self.global_step = 0
        self.step_in_epoch = 0
        self.steps_per_epoch = 0
        self.step_metrics: dict = {}
        self.epoch_results: dict = {}
        self.lr_scale = 1.0
        self.epoch_lr_scale = 1.0
        # the sp group decays on its own sp_lr_drop_epochs (reference
        # train_detector.py:79-88): EpochLRHook(attr='sp_epoch_lr_scale')
        self.sp_epoch_lr_scale = 1.0

    def call_hooks(self, name: str):
        for h in self.hooks:
            getattr(h, name)(self)

    def read_metrics(self) -> dict:
        """The step's metrics as floats, over the ranks: the losses (this
        rank's shares) summed, the others (the gradient norm, the same on
        every rank; the logging errors) averaged.  Every rank must call it
        at the same step."""
        keys = list(self.step_metrics)
        if not keys:
            return {}
        vals = global_sum(torch.stack([torch.as_tensor(self.step_metrics[k]).float()
                                       for k in keys])).tolist()
        return {k: v if k.startswith("loss") else v / world_size() for k, v in zip(keys, vals)}


class Trainer(SolverBase):
    def __init__(self, step_fn, state: TrainState, dataloader, *, device, seed: int = 0,
                 hooks=(), validers=()):
        super().__init__(hooks)
        self.step_fn = step_fn
        self.state = state
        self.dataloader = dataloader
        self.device = device
        self.seed = seed
        # validers run INSIDE the epoch, before the after_epoch hooks, so the
        # checkpoint's top-k by metric and the logs see THIS epoch's results
        # (reference det_solver.py:137-148)
        self.validers = list(validers)

    def run_epoch(self, epoch: int) -> TrainState:
        self.epoch = epoch
        self.steps_per_epoch = len(self.dataloader)
        self.call_hooks("before_epoch")
        # an epoch-keyed dropout stream: a resumed run's epoch E draws the same
        # masks as an uninterrupted run's epoch E
        if self.state.generator is not None:
            self.state.generator.manual_seed(self.seed * 1_000_003 + epoch)
        for it, batch in enumerate(self.dataloader):
            self.step_in_epoch = it
            self.call_hooks("before_step")
            self.state, self.step_metrics = self.step_fn(
                self.state, to_device(batch["samples"], self.device),
                to_device(batch["targets"], self.device),
                self.lr_scale * self.epoch_lr_scale, self.lr_scale * self.sp_epoch_lr_scale)
            self.global_step += 1
            self.call_hooks("after_step")
        # fresh results each epoch: an empty valider summary must not leave
        # the previous epoch's metrics visible to the after_epoch hooks
        self.epoch_results = {}
        for valider in self.validers:
            res = valider.run_epoch(epoch)
            if res:
                self.epoch_results = {**self.epoch_results, **res}
        self.call_hooks("after_epoch")
        return self.state


class Valider(SolverBase):
    def __init__(self, model_getter: Callable, dataloader, evaluator_factory, *, device,
                 hooks=()):
        super().__init__(hooks)
        self.model_getter = model_getter
        self.dataloader = dataloader
        self.evaluator_factory = evaluator_factory
        self.device = device

    @torch.no_grad()
    def run_epoch(self, epoch: int) -> dict:
        self.epoch = epoch
        self.call_hooks("before_epoch")
        evaluator = self.evaluator_factory()
        model = unwrap(self.model_getter())    # the rank's local model
        was_training = model.training
        model.eval()
        for batch in self.dataloader:
            if not batch["image_id"]:          # a rank's empty share of the last batch
                continue
            out = model(to_device(batch["samples"], self.device), training=False)
            results = postprocess(out["pred_logits"], out["pred_boxes"],
                                  torch.as_tensor(batch["orig_sizes"]))
            evaluator.update(batch["image_id"],
                             {k: v.cpu().numpy() for k, v in results.items()})
        model.train(was_training)
        evaluator.synchronize_between_processes()   # every rank's predictions
        self.epoch_results = evaluator.summarize()
        print(f"epoch {epoch} eval: {self.epoch_results}")
        self.call_hooks("after_epoch")
        return self.epoch_results
