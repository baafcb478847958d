"""Tensor parallelism's collectives as autograd functions (Megatron's
conjugate pair and the gather), over a tensor-parallel group of ranks.

grit_tpu shards the widest products over a mesh's ``model`` axis and lets
GSPMD insert the collectives (grit_tpu/parallel/mesh.py).  Here a split
``Linear`` holds its rank's slice and the module that owns it calls these:

- ``copy_to_tp``: the input of a column-split product (every rank holds all
  of it).  Forward the identity, backward the all-reduce of the input's
  gradient, to which each rank's columns contribute a part;
- ``reduce_from_tp``: the output of a row-split product, each rank's partial
  sum.  Forward the all-reduce of the partials, taken in f32 (a bf16 partial
  is cast up first, never summed in bf16), backward the identity (every rank
  holds the same gradient of the sum);
- ``gather_from_tp``: the output of a column-split product that the next
  operation needs whole (the vocab head's logits before ``log_softmax``).
  Forward the all-gather on the last dim in rank order, backward this rank's
  slice of the gradient.

With ``group`` None, or a group of one rank, each is the identity and issues
no collective.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

#: the collectives these functions issued (forward and backward), and
#: ``parallel.mesh.tie_replicated_grads``' broadcasts, with their bytes: the
#: numbers chip_smoke.py prints a caption batch and an XE step
COLLECTIVES = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0,
               "broadcast": 0, "broadcast_bytes": 0}


def tp_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def tp_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy.clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _all_reduce(x.float().clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy.to(ctx.dtype), None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(tp_size(group))]
        dist.all_gather(parts, x, group=group)
        COLLECTIVES["all_gather"] += 1
        COLLECTIVES["all_gather_bytes"] += x.numel() * x.element_size() * len(parts)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, dy):
        return dy.chunk(tp_size(ctx.group), -1)[tp_rank(ctx.group)].contiguous(), None


def copy_to_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group``."""
    return x if tp_size(group) == 1 else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The f32 sum over ``group`` of each rank's partial ``x``; identity
    backward (the gradient in ``x``'s dtype).  One rank: ``x`` in f32."""
    return x.float() if tp_size(group) == 1 else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The ranks' ``x`` concatenated on the last dim in rank order; the
    gradient's slice of this rank backward."""
    return x if tp_size(group) == 1 else _GatherFromTP.apply(x, group)
