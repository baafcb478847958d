"""Exact linear sum assignment of many small problems: the detector's matcher.

``linear_sum_assignment(cost [P, Q, G], n_valid [P]) -> assign [P, G]``
computes what ``jax.vmap(grit_tpu.detection.losses._device_lsa_single)``
computes: for each problem, the queries (Q) matched to its first
``n_valid`` gt columns by the shortest-augmenting-path Hungarian algorithm,
-1 past ``n_valid``.  The costs are cast to f32 and the columns past
``n_valid`` read as 0, as the JAX solver has them; every one of the G rows is
solved, padding rows included, so that the assignments are the JAX solver's
also where costs tie.

On CUDA tensors it launches ``grit_lsa`` (``csrc/lsa.cu``: one block a
problem, the loops on the device; design notes there) once for all P
problems, or raises; on CPU tensors it runs ``lsa_plain``, the JAX solver's
algorithm step for step in tensor ops, all problems in lockstep.  No Pallas
kernel stands behind it: it ports lax control flow, which PyTorch can only
run on the device as a kernel.
"""

from __future__ import annotations

import torch

from grit_tpu_torch.ops import _cuda

#: Kernel launches (one per call that reached the CUDA kernel).
LAUNCHES = {"lsa": 0}

INF = 3e38           # the JAX solver's finite "infinity": delta * 0 stays 0
MAX_QUERIES = 1024   # a thread a column in one block
SMEM_LIMIT = 232448  # an H100 block's dynamic shared memory, in bytes


def smem_bytes(q: int, g: int) -> int:
    """Shared memory of one problem's block: the transposed costs, u, p, way
    and the reduction's 192 words (as ``lsa_smem_bytes`` in csrc/lsa.cu)."""
    return 4 * (g * q + g + (q + 1) + q + 192)


def _check_shape(cost: torch.Tensor, n_valid: torch.Tensor) -> None:
    if cost.dim() != 3:
        raise ValueError(f"linear_sum_assignment: cost must be [P, Q, G], got {tuple(cost.shape)}")
    p, q, g = cost.shape
    if tuple(n_valid.shape) != (p,):
        raise ValueError(f"linear_sum_assignment: n_valid must be [{p}], got "
                         f"{tuple(n_valid.shape)}")
    if g > q:
        raise ValueError(f"linear_sum_assignment: {g} gt columns exceed {q} queries: the "
                         f"solver matches every gt row")


def lsa_plain(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Plain version of ``grit_lsa``: ``_device_lsa_single``'s f32 operations
    in the same order, every problem advanced together and an ended problem's
    state held by masks (the host reads whether any is still running once an
    iteration)."""
    _check_shape(cost, n_valid)
    p_, q, g = cost.shape
    dev = cost.device
    nv = n_valid.to(device=dev, dtype=torch.int64).clamp(0, g)
    rows = torch.arange(g, device=dev)
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    # rows = gts, cols = queries: a[b, i, j] = cost[b, j, i], 0 on the padding rows
    a = torch.where(rows[None, None, :] < nv[:, None, None], cost.to(torch.float32),
                    0.0).transpose(1, 2).contiguous()
    ar = torch.arange(p_, device=dev)
    u = torch.zeros(p_, g, device=dev)
    v = torch.zeros(p_, q + 1, device=dev)
    p = torch.full((p_, q + 1), -1, dtype=torch.int64, device=dev)
    for i in range(g):
        p[:, q] = i
        minv = torch.full((p_, q), INF, device=dev)
        way = torch.zeros(p_, q, dtype=torch.int64, device=dev)
        used = torch.zeros(p_, q + 1, dtype=torch.bool, device=dev)
        j0 = torch.full((p_,), q, dtype=torch.int64, device=dev)
        active = torch.ones(p_, dtype=torch.bool, device=dev)
        while bool(active.any()):
            used = used | (active[:, None] & (torch.arange(q + 1, device=dev) == j0[:, None]))
            i0 = p[ar, j0].clamp(min=0)
            cur = (a[ar, i0] - u[ar, i0][:, None]) - v[:, :q]
            cur = torch.where(used[:, :q], inf, cur)
            upd = (cur < minv) & active[:, None]
            minv = torch.where(upd, cur, minv)
            way = torch.where(upd, j0[:, None], way)
            masked = torch.where(used[:, :q], inf, minv)
            j1 = masked.argmin(1)     # the first least index, as jnp.argmin
            delta = masked[ar, j1][:, None]
            live = used & active[:, None]
            # u[p[j]] += delta on the used columns: distinct rows, one add each
            hit = torch.zeros(p_, g + 1, dtype=torch.bool, device=dev).scatter_(
                1, torch.where(live, p, g), True)[:, :g]
            u = torch.where(hit, u + delta, u)
            v = torch.where(live, v - delta, v)
            minv = torch.where(~used[:, :q] & active[:, None], minv - delta, minv)
            j0 = torch.where(active, j1, j0)
            active = p[ar, j0] >= 0
        # the augmenting walk: p[j0] = p[way[j0]] until the virtual column
        walking = j0 != q
        while bool(walking.any()):
            j1 = way[ar, j0.clamp(max=q - 1)]
            moved = p[ar, j1]
            p[ar[walking], j0[walking]] = moved[walking]
            j0 = torch.where(walking, j1, j0)
            walking = j0 != q
    assign = torch.full((p_, g + 1), -1, dtype=torch.int64, device=dev)
    cols = torch.arange(q, device=dev).expand(p_, q)
    assign.scatter_(1, torch.where(p[:, :q] >= 0, p[:, :q], g), cols)
    return torch.where(rows[None, :] < nv[:, None], assign[:, :g], -1)


def linear_sum_assignment(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """assign [P, G] (int64) of ``cost`` [P, Q, G] and ``n_valid`` [P] (see
    the module docstring).  CPU tensors run ``lsa_plain``; CUDA tensors one
    ``grit_lsa`` launch, with no host transfer, or raise."""
    _check_shape(cost, n_valid)
    if cost.device.type == "cpu":
        return lsa_plain(cost, n_valid)
    p, q, g = cost.shape
    if q > MAX_QUERIES or smem_bytes(q, g) > SMEM_LIMIT:
        raise ValueError(f"linear_sum_assignment: a problem of {q} queries x {g} gt columns "
                         f"needs {smem_bytes(q, g)} bytes of shared memory and {q} threads; "
                         f"grit_lsa takes at most {SMEM_LIMIT} bytes and {MAX_QUERIES} queries")
    # .to and not .float(): the solver is f32 whatever the costs' type
    cost = cost.to(torch.float32).contiguous()
    n_valid = n_valid.to(device=cost.device, dtype=torch.int64).contiguous()
    assign = torch.empty(p, g, dtype=torch.int64, device=cost.device)
    if p == 0:
        return assign
    for name, t in (("cost", cost), ("n_valid", n_valid), ("assign", assign)):
        _cuda.require(t, name)
    lib = _cuda.library()
    _cuda.check(lib.grit_lsa(cost.data_ptr(), n_valid.data_ptr(), assign.data_ptr(), p, q, g,
                             _cuda.stream()), "lsa")
    LAUNCHES["lsa"] += 1
    return assign
