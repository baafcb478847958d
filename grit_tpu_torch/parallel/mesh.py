"""The layouts over ranks: data parallel (one process a card,
``DistributedDataParallel``) and tensor parallel (grit_tpu's ``model`` axis).

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

Tensor parallel: grit_tpu's mesh is (data, model), the model axis fastest
(``make_mesh`` reshapes the devices to ``(n_data, n_model)``), and
``param_shardings`` splits the widest products over the model axis
(``_TP_RULES``): the vocab head's columns, every FFN's fc1 columns and fc2
rows (``pwff``: the grid net and the caption decoder) and every Swin block's
MLP likewise.  Here ``make_groups(dp, tp)`` gives rank r the data group of
the ranks with its ``r % tp`` and the tensor group {r - r % tp, ...};
``tp_plan`` says which weights split (the same rules in the port's names, a
``[out, in]`` weight split on dim 0 where flax splits a kernel's columns and
on dim 1 where it splits rows; only where the dimension divides, as
``param_shardings``), ``shard_model`` keeps this rank's slices and
``gather_tp_state`` puts the whole state back together;
``tie_replicated_grads`` keeps the parameters a tensor group holds whole
equal across it.  The modules that own
a split weight (``models.attention.FeedForward``, ``models.swin.Mlp``,
``models.cap_generator.CaptionGenerator``) then run their products on the
slice and meet through ``parallel.tensor``'s collectives.  A batch is dealt
over the data axis only (``shard_batch(tree, dp_rank, dp)``): a tensor group's
ranks see the same rows.  The normalisers and the loss scaling of
``engine/xe.py`` and ``engine/scst.py`` may stay over the whole world: the
tensor group's ``tp`` copies of each count and each loss share cancel against
``world_size() = dp * tp``.  DDP averages over the data group only
(``wrap_data_parallel(..., group=dp_group)``).
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from grit_tpu_torch.parallel.distributed import allgather_pyobj, rank, world_size
from grit_tpu_torch.parallel.tensor import COLLECTIVES, tp_rank, tp_size
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
                       probe: Optional[Callable[[nn.Module], torch.Tensor]] = None,
                       group=None) -> nn.Module:
    """``model`` under ``DistributedDataParallel`` over ``group`` (the data
    group; default the whole world) when that holds more than one rank, else
    ``model`` itself.

    DDP all-reduces the gradient of every parameter that requires one and
    raises when one gets none in a step, so ``exclude_untrained(model,
    trained=trained, probe=probe)`` runs first whenever more than one rank
    runs; the ranks must agree on what is left.  ``broadcast_buffers=False``:
    GRIT has no BatchNorm.  The gradients stay f32 (no compression hook)."""
    if world_size() == 1:
        return model
    trains = exclude_untrained(model, trained=trained, probe=probe)
    if any(other != trains for other in allgather_pyobj(trains)):
        raise RuntimeError("wrap_data_parallel: the ranks train different parameters")
    if group is not None and tp_size(group) == 1:
        return model
    device = torch.device(device)
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index if device.index is not None
                           else torch.cuda.current_device()] if device.type == "cuda" else None,
        broadcast_buffers=False, process_group=group)


# ---------------------------------------------------------------------------
# tensor parallel
# ---------------------------------------------------------------------------

#: grit_tpu's ``_TP_RULES`` in the port's names -> the dim of the torch weight
#: that splits: 0 (out) where flax splits the kernel's columns, 1 (in) where
#: it splits its rows
TP_RULES: list[tuple[re.Pattern, int]] = [
    (re.compile(r"cap_generator\.fc\.weight$"), 0),     # the vocab head's columns
    (re.compile(r"pwff\.fc1\.weight$"), 0),              # FFN d_ff columns
    (re.compile(r"pwff\.fc2\.weight$"), 1),              # FFN d_ff rows (contracting)
    (re.compile(r"mlp\.fc1\.weight$"), 0),               # Swin MLPs
    (re.compile(r"mlp\.fc2\.weight$"), 1),
]


def tp_plan(params, tp: int) -> dict[str, int]:
    """{weight name: the dim split over ``tp`` ranks} of a model (or of a
    mapping name -> tensor or shape): ``TP_RULES``, applied only where that
    dim divides by ``tp`` (``param_shardings``' rule).  Empty at tp 1."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    if tp <= 1:
        return {}
    plan = {}
    for name, value in params.items():
        shape = tuple(getattr(value, "shape", value))
        for pat, dim in TP_RULES:
            if pat.search(name):
                if dim < len(shape) and shape[dim] % tp == 0:
                    plan[name] = dim
                break
    return plan


def make_groups(dp: int, tp: int):
    """This rank's (data group, tensor group) of a ``dp x tp`` world, the
    tensor axis fastest as grit_tpu's ``make_mesh``: tensor groups {0 .. tp-1},
    {tp .. 2tp-1}, ...; data groups {j, j + tp, ...}.  Every rank creates
    every group (``dist.new_group`` is collective)."""
    world = world_size()
    if dp * tp != world:
        raise ValueError(f"make_groups: dp {dp} x tp {tp} != world {world}")
    r = rank()
    dp_group = tp_group = None
    for j in range(tp):
        g = dist.new_group(list(range(j, world, tp)))
        if r % tp == j:
            dp_group = g
    for i in range(dp):
        g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
        if r // tp == i:
            tp_group = g
    return dp_group, tp_group


def _owner(model: nn.Module, weight_name: str) -> tuple[nn.Module, nn.Module]:
    """(the Linear of a split weight, the module that owns that Linear)."""
    path = weight_name.split(".")[:-1]
    return model.get_submodule(".".join(path)), model.get_submodule(".".join(path[:-1]))


def shard_model(model: nn.Module, plan: dict[str, int], group) -> nn.Module:
    """Keep this rank's slices of the weights ``plan`` splits (``tp_plan``),
    rank r of ``group`` the r-th of ``tp`` equal chunks; a column-split
    (dim 0) Linear's bias goes with its columns (grit_tpu keeps it whole and
    lets GSPMD slice it: the same sums, and no all-reduce of a whole bias's
    gradient here), a row-split one's stays whole and is added once, after
    the reduction.  Marks each split Linear (``tp_dim``, ``tp_group``) and
    its owner (``tp_group``), whose forward then takes the tensor-parallel
    path.  In place; returns ``model``."""
    tp, r = tp_size(group), tp_rank(group)
    if not plan or tp == 1:
        return model
    for name, dim in plan.items():
        lin, owner = _owner(model, name)
        for leaf in ("weight", "bias") if dim == 0 else ("weight",):
            p = getattr(lin, leaf)
            if p is None:
                continue
            piece = p.detach().chunk(tp, dim if leaf == "weight" else 0)[r].clone()
            setattr(lin, leaf, nn.Parameter(piece, requires_grad=p.requires_grad))
        lin.tp_dim, lin.tp_group = dim, group
        owner.tp_group = group
    return model


def tie_replicated_grads(optimizer: torch.optim.Optimizer, model: nn.Module, group):
    """Keep the parameters that every rank of the tensor group ``group``
    holds whole bit-equal across the group: before each step of
    ``optimizer``, their gradients are broadcast from the group's first rank
    (one collective a dtype).  The ranks compute the same gradient of a
    replicated parameter up to the order of a kernel's atomic sums (K6's
    value gradient on the card), and Adam's first step moves an element by
    its gradient's sign: without this the replicas drift apart.  ``model``:
    the unwrapped model.  A group of one rank: nothing is registered ->
    the hook's handle, or None."""
    if tp_size(group) == 1:
        return None
    split = split_params(model)
    params = [p for n, p in model.named_parameters() if n not in split]
    src = dist.get_process_group_ranks(group)[0]

    def broadcast_grads(opt, args, kwargs):
        by_dtype: dict = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch._utils._flatten_dense_tensors(grads)
            dist.broadcast(flat, src, group=group)
            COLLECTIVES["broadcast"] += 1
            COLLECTIVES["broadcast_bytes"] += flat.numel() * flat.element_size()
            for g, synced in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
                g.copy_(synced)

    return optimizer.register_step_pre_hook(broadcast_grads)


def split_params(model: nn.Module) -> dict[str, int]:
    """{parameter name: the dim split} of a ``shard_model``'d model: the
    split weights and the biases that went with their columns."""
    out = {}
    for name, mod in model.named_modules():
        dim = getattr(mod, "tp_dim", None)
        if dim is not None:
            out[f"{name}.weight"] = dim
            if dim == 0 and mod.bias is not None:
                out[f"{name}.bias"] = 0
    return out


def gather_tp_state(model: nn.Module) -> dict[str, torch.Tensor]:
    """The whole state_dict of a ``shard_model``'d model (what ``convert.py``
    and the checkpoints see): each split parameter (``split_params``)
    all-gathered over its tensor group in rank order.  Every rank of the group
    must call it.  Unsplit entries are this rank's own tensors."""
    state = dict(model.state_dict())
    for name, dim in split_params(model).items():
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        t = getattr(mod, leaf).detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(tp_size(mod.tp_group))]
        dist.all_gather(parts, t, group=mod.tp_group)
        state[name] = torch.cat(parts, dim)
    return state
