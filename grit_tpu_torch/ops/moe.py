"""The routed experts of a mixture-of-experts layer: rows sorted by expert,
then two grouped GEMMs.

No TPU kernel of grit_tpu computes this (the JAX package has no mixture of
experts); it serves the ``mla_moe`` caption decoder
(``models/lm_decoder.py``).  For ``n`` rows, each routed to ``k`` of ``E``
experts with weights ``w``:

  slots   = the n * k (row, expert) pairs, sorted by expert (stably)
  [g | u] = x[row_s] W13[e_s]^T                                 gate+up
  h[s]    = silu(g) * u
  y[s]    = h[s] W2[e_s]^T                                      down
  out[r]  = sum over the k slots of row r of w_s y[s]  (f32, in slot order)

``w13`` [E, 2 I, D] holds each expert's gate rows then its up rows, ``w2``
[E, D, I] its down projection, both as torch's ``Linear`` lays a weight out.

In bf16 each product is one call of the library's grouped GEMM,
``torch._grouped_mm`` (on an H100 one CUTLASS launch over every expert's
group of sorted rows, the groups given by their ends, so nothing is read
back to the host); SwiGLU, the routing weights and the scatter back to
each row's slots are plain PyTorch between and after them, and the sum over
a row's k slots runs in a fixed order (the same bits from call to call).
At decode (640 rows, 64 experts, 6 a row) every expert is hit and the
products are bound by reading the experts' weights (1.1 GB a layer in
bf16); at a b128 prefill (27008 rows) by their operations.  In another type
(the CPU tests' float32) the same arithmetic runs expert by expert
(``grouped_plain``).

While torch.profiler records (the switch of ``utils.misc.trace_annotation``)
each call appends its rows per expert, a device tensor [E], to
``EXPERT_LOAD`` (``take_expert_load`` empties it); otherwise the path reads
nothing more.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: Calls of the library's grouped GEMM, by product
LAUNCHES = {"moe_gate_up": 0, "moe_down": 0}

#: Rows routed to each expert, a device tensor [E] per call, kept only while
#: the profiler records
EXPERT_LOAD: list[torch.Tensor] = []


def take_expert_load() -> list[torch.Tensor]:
    """The loads recorded since the last call, oldest first."""
    out = list(EXPERT_LOAD)
    EXPERT_LOAD.clear()
    return out


def sort_by_expert(idx: torch.Tensor, n_experts: int):
    """idx [n, k] expert ids -> (order [n k]: the flat slots sorted by expert,
    stably; rows [n k]: the row of each sorted slot; counts [E];
    offs int32 [E + 1]: where each expert's slots start).  Nothing is read
    back to the host (``torch.bincount`` would read the ids' extremes on
    every call: two waits for the device a MoE layer a decode step)."""
    k = idx.shape[1]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = flat.new_zeros(n_experts).scatter_add_(0, flat, torch.ones_like(flat))
    offs = F.pad(torch.cumsum(counts, 0), (1, 0)).to(torch.int32)
    return order, order // k, counts, offs


def routed_experts(x: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                   w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x [n, D], idx [n, k] long, weight [n, k] f32 -> f32 [n, D]: the sum of
    each row's k routed experts, weighted."""
    n, k = idx.shape
    order, rows, counts, offs = sort_by_expert(idx, w13.shape[0])
    if torch.autograd.profiler._is_profiler_enabled:
        EXPERT_LOAD.append(counts)
    gu = grouped_mm(x[rows], w13, offs, "moe_gate_up")
    i = w13.shape[1] // 2
    h = F.silu(gu[:, :i]) * gu[:, i:]
    y = grouped_mm(h, w2, offs, "moe_down")
    out = torch.empty((n * k, w2.shape[1]), dtype=torch.float32, device=x.device)
    out[order] = y * weight.reshape(-1)[order, None].float()
    return out.view(n, k, -1).sum(1)


def grouped_mm(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor, name: str) -> torch.Tensor:
    """a [S, K] sorted by expert (expert e's rows ``[offs[e], offs[e + 1])``),
    w [E, N, K] -> [S, N] in a's type: each expert's rows times its
    ``w[e]^T``.  bf16 through ``torch._grouped_mm``, counted in ``LAUNCHES``
    under ``name``; otherwise ``grouped_plain``."""
    if a.dtype != torch.bfloat16:
        return grouped_plain(a, w, offs)
    LAUNCHES[name] += 1
    return torch._grouped_mm(a, w.transpose(1, 2), offs[1:])


def grouped_plain(a, w, offs):
    """``grouped_mm`` expert by expert (f32 products)."""
    out = torch.empty((a.shape[0], w.shape[1]), dtype=a.dtype, device=a.device)
    bounds = offs.tolist()
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[lo:hi] = F.linear(a[lo:hi].float(), w[e].float()).to(a.dtype)
    return out
