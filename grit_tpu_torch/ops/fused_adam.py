"""Single-pass Adam update over many tensors: kernel K12.

``adam_update`` replaces the TPU's ``grit_tpu/ops/fused_adam.py``
``_adam_kernel`` (via ``_adam_flat_pallas`` and ``scale_by_adam_flat``) and the
two jnp ops that follow it in the training steps, ``apply_lr`` and
``optax.apply_updates``: moments and parameters are updated in place in one
pass,

  mu' = (1 - b1) g + b1 mu          nu' = (1 - b2) g^2 + b2 nu
  u   = (mu' / c1) / (sqrt(nu' / c2 + eps_root) + eps)
  p'  = p + (-lr) (u + wd p)

with the bias corrections ``c1 = 1 - b1^t``, ``c2 = 1 - b2^t`` computed on the
host in f32, as optax computes them.  The weight decay is
``optax.add_decayed_weights`` after the Adam scaling: decoupled from the
moments and scaled by the learning rate.  Every scalar is rounded to f32 once,
here, so the kernel and the plain version use the same values.

On CUDA tensors it launches the multi-tensor kernel in ``csrc/adam.cu`` (one
launch for all the leaves it is given; design notes there) or raises; on CPU
tensors it runs ``adam_update_plain``, a loop of tensor ops in the same order.
The TPU version's flat buckets (``make_flat_spec`` / ``flatten_f32``) have no
counterpart: a table of the leaves' addresses takes their place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from grit_tpu_torch.ops import _cuda

#: Kernel launches (one per call that reached the CUDA kernel).
LAUNCHES = {"adam": 0}

CHUNK = 4096   # elements per block, as ADAM_CHUNK in csrc/adam.cu


def _f32(x: float) -> float:
    return float(np.float32(x))


def adam_scalars(step: int, lr: float, b1: float, b2: float, eps: float, eps_root: float,
                 weight_decay: float) -> dict[str, float]:
    """The update's scalars, each rounded to f32 once.  ``step`` counts from 1."""
    one = np.float32(1.0)
    return {
        "omb1": _f32(1.0 - b1), "b1": _f32(b1), "omb2": _f32(1.0 - b2), "b2": _f32(b2),
        # optax's bias_correction: 1 - decay**count in f32
        "c1": float(one - np.power(np.float32(b1), np.float32(step))),
        "c2": float(one - np.power(np.float32(b2), np.float32(step))),
        "eps": _f32(eps), "eps_root": _f32(eps_root), "neg_lr": _f32(-lr),
        "wd": _f32(weight_decay),
    }


def adam_update_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                      mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor], *, step: int,
                      lr: float, b1: float, b2: float, eps: float = 1e-8,
                      eps_root: float = 0.0, weight_decay: float = 0.0) -> None:
    """Plain version of K12: the same f32 operations in the same order, leaf by
    leaf, in place."""
    s = adam_scalars(step, lr, b1, b2, eps, eps_root, weight_decay)
    with torch.no_grad():
        for p, g, mu, nu in zip(params, grads, mus, nus):
            mu.mul_(s["b1"]).add_(g * s["omb1"])
            nu.mul_(s["b2"]).add_((g * g) * s["omb2"])
            u = (mu / s["c1"]) / ((nu / s["c2"] + s["eps_root"]).sqrt() + s["eps"])
            if s["wd"] != 0.0:
                u = u + p * s["wd"]
            p.add_(u * s["neg_lr"])


class LeafTable:
    """Device tables of one launch: the leaves' (p, g, mu, nu) addresses and
    sizes, and each block's (leaf, chunk of the leaf).  ``signature`` is what
    it was built from; the tensors it points to are kept alive by the caller."""

    def __init__(self, signature: tuple, device: torch.device):
        self.signature = signature
        ptrs = [a for leaf in signature for a in leaf[:4]]
        sizes = [leaf[4] for leaf in signature]
        chunks = [(i, c) for i, n in enumerate(sizes) for c in range(-(-n // CHUNK))]
        self.n_chunks = len(chunks)
        self.ptrs = torch.tensor(ptrs, dtype=torch.int64, device=device)
        self.sizes = torch.tensor(sizes, dtype=torch.int64, device=device)
        self.chunks = torch.tensor(chunks, dtype=torch.int32, device=device).reshape(-1, 2)


def adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor], *, step: int,
                lr: float, b1: float, b2: float, eps: float = 1e-8, eps_root: float = 0.0,
                weight_decay: float = 0.0,
                table: Optional[LeafTable] = None) -> Optional[LeafTable]:
    """K12: one Adam step on every leaf, in place (see the module docstring).

    All leaves are f32 and contiguous, on one device.  CPU tensors run the
    plain version and return None; CUDA tensors launch the kernel once or
    raise, and return the launch's ``LeafTable``: pass it back at the next step
    and it is rebuilt only when an address or a size changed (a gradient that
    was reallocated, a state that was loaded)."""
    if not params:
        return table
    if params[0].device.type == "cpu":
        adam_update_plain(params, grads, mus, nus, step=step, lr=lr, b1=b1, b2=b2, eps=eps,
                          eps_root=eps_root, weight_decay=weight_decay)
        return None
    device = params[0].device
    signature = tuple((p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel())
                      for p, g, mu, nu in zip(params, grads, mus, nus))
    if table is None or table.signature != signature:
        # leaves are validated when their table is built, not at every step
        for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus)):
            for name, t in (("param", p), ("grad", g), ("mu", mu), ("nu", nu)):
                if (not t.is_cuda or t.device != device or t.dtype != torch.float32
                        or not t.is_contiguous() or t.shape != p.shape or t.data_ptr() % 4):
                    raise ValueError(f"adam_update: leaf {i} {name}: expected a contiguous f32 "
                                     f"tensor of shape {tuple(p.shape)} on {device}, got "
                                     f"{t.dtype} {tuple(t.shape)} on {t.device}")
        table = LeafTable(signature, device)
    s = adam_scalars(step, lr, b1, b2, eps, eps_root, weight_decay)
    lib = _cuda.library()
    _cuda.check(lib.grit_adam(table.ptrs.data_ptr(), table.sizes.data_ptr(),
                              table.chunks.data_ptr(), table.n_chunks,
                              s["omb1"], s["b1"], s["omb2"], s["b2"], s["c1"], s["c2"],
                              s["eps"], s["eps_root"], s["neg_lr"], s["wd"], _cuda.stream()),
                "adam")
    LAUNCHES["adam"] += 1
    return table
