"""Data-parallel layout: one process a card, ``DistributedDataParallel``.

grit_tpu shards a batch over a mesh's ``data`` axis and lets GSPMD insert the
gradient all-reduce (grit_tpu/parallel/mesh.py).  Here each rank holds its
share of the global batch and a replica of the parameters, and
``DistributedDataParallel`` averages the f32 gradients across ranks during the
backward.  What GSPMD computes over the global batch, the port computes the
same way: every normaliser (token count, SCST image count, detection box
count) is summed over the ranks (``global_sum``) and each rank's loss is its
share of the global loss times the world size, so that DDP's mean of the
ranks' gradients is the global batch's gradient.

Rank r's rows of a global batch are rows r, r + world, ... (``shard_batch``),
as the loaders deal them (``data/coco.py``, ``detection/loader.py``): the
ranks' batches of step t together are the one-process batch of step t.

grit_tpu's tensor-parallel rules (``_TP_RULES``, ``param_shardings``) are not
ported: no CLI uses a ``model`` axis.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from grit_tpu_torch.parallel.distributed import allgather_pyobj, rank, world_size
from grit_tpu_torch.utils.nested import ImageBatch, pad_leading, round_up


def pad_to_multiple(tree, multiple: int, int_fill: int = 1, int_first: Optional[int] = None):
    """Pad each array's leading axis up to a multiple of ``multiple``, with
    ``utils.nested.pad_leading``'s conventions (grit_tpu's ``pad_to_multiple``:
    images, features and masks with zeros; integer leaves but uint8 images
    with ``int_fill``, their first column with ``int_first``, the ``<bos>`` id
    that a caption row needs so that its queries see one key)."""
    if isinstance(tree, ImageBatch):
        return ImageBatch(*(pad_to_multiple(t, multiple) for t in tree))
    if isinstance(tree, dict):
        return {k: pad_to_multiple(v, multiple, int_fill, int_first) for k, v in tree.items()}
    if getattr(tree, "ndim", 0) == 0 or multiple <= 1:
        return tree
    return pad_leading(tree, round_up(tree.shape[0], multiple), int_fill, int_first)


def shard_batch(tree, rank_: Optional[int] = None, world: Optional[int] = None, *,
                int_fill: int = 1, int_first: Optional[int] = None):
    """Rank ``rank_``'s share of a global host batch: rows rank_, rank_ + world,
    ... after ``pad_to_multiple(tree, world)``, so every rank gets as many rows
    (the pad rows carry no weight), each array contiguous as the kernels take
    it.  Defaults: this process's rank and world."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    tree = pad_to_multiple(tree, world, int_fill, int_first)
    if isinstance(tree, ImageBatch):
        return ImageBatch(*(shard_batch(t, rank_, world) for t in tree))
    if isinstance(tree, dict):
        return {k: shard_batch(v, rank_, world) for k, v in tree.items()}
    if isinstance(tree, list):      # ids, reference captions: the real rows only
        return tree[rank_::world]
    if getattr(tree, "ndim", 0) == 0:
        return tree
    rows = tree[rank_::world]
    return rows.contiguous() if torch.is_tensor(rows) else np.ascontiguousarray(rows)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, detached (normalisers and logged metrics;
    no gradient flows through it).  One rank: ``t`` detached."""
    t = t.detach()
    if world_size() == 1:
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


def unwrap(model: nn.Module) -> nn.Module:
    """The module a ``DistributedDataParallel`` wraps, or ``model`` itself."""
    return model.module if isinstance(model, nn.parallel.DistributedDataParallel) else model


def exclude_untrained(model: nn.Module, *, trained=None,
                      probe: Optional[Callable[[nn.Module], torch.Tensor]] = None) -> list[str]:
    """Stop the parameters a step leaves without a gradient from requiring
    one -> the names of those that still do.  First those outside ``trained``
    (the optimizer's: frozen Swin stages, ``pos_emb``), then those that
    ``probe(model)`` (a loss of one training forward of the phase, on a
    batch's first rows) leaves without a gradient: the heads a captioner does
    not run, the whole detector of the freezing mode.  The optimizer skips a
    parameter without a gradient either way, so a step is unchanged."""
    if trained is not None:
        keep = {id(p) for p in trained}
        for p in model.parameters():
            if id(p) not in keep:
                p.requires_grad_(False)
    if probe is not None:
        probe(model).backward()
        for p in model.parameters():
            if p.requires_grad and p.grad is None:
                p.requires_grad_(False)
            p.grad = None
    return sorted(n for n, p in model.named_parameters() if p.requires_grad)


def wrap_data_parallel(model: nn.Module, device, *, trained=None,
                       probe: Optional[Callable[[nn.Module], torch.Tensor]] = None) -> nn.Module:
    """``model`` under ``DistributedDataParallel`` when more than one rank
    runs, else ``model`` itself.

    DDP all-reduces the gradient of every parameter that requires one and
    raises when one gets none in a step, so ``exclude_untrained(model,
    trained=trained, probe=probe)`` runs first; the ranks must agree on what
    is left.  ``broadcast_buffers=False``: GRIT has no BatchNorm.  The
    gradients stay f32 (no compression hook)."""
    if world_size() == 1:
        return model
    trains = exclude_untrained(model, trained=trained, probe=probe)
    if any(other != trains for other in allgather_pyobj(trains)):
        raise RuntimeError("wrap_data_parallel: the ranks train different parameters")
    device = torch.device(device)
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index if device.index is not None
                           else torch.cuda.current_device()] if device.type == "cuda" else None,
        broadcast_buffers=False)
