"""The decode-layer tail in one call: kernel K11.

``fused_decode_layer_tail`` replaces the TPU's ``grit_tpu/ops/decode_layer.py``
``_kernel`` (via ``_call`` and the function of the same name there), with its
signature and layouts: everything a ``ParallelAttentionLayer`` decode step
does after its self-attention,

  enc_i   = LN_i(x + fc_o_i(softmax(q_i k_i^T / sqrt(d) + mask_i) v_i)) * pad
  alpha_i = sigmoid(x @ Ws_i + enc_i @ We_i + b_i)
  enc     = (enc_1 * alpha_1 + enc_2 * alpha_2) / sqrt(2) * pad
  out     = LN_f(enc + fc2(relu(fc1(enc)))) * pad

On CUDA tensors it launches the hand-written chain in ``csrc/decode_layer.cu``
(design notes there) or raises; on CPU tensors it runs
``decode_layer_tail_plain``, the counterpart of that module's ``_ref``:
operands of every product in the compute dtype, f32 for the q scaling, the
additive mask, softmax, LayerNorm (``var = E[x^2] - mu^2``), gates and
residuals, one rounding to the output dtype.  As on the TPU there is no
backward kernel: the gradient recomputes through the plain version.

Tensor parallel (``fused_decode_layer_tail_tp``): a rank's weights hold
F / tp of fc1's columns and fc2's rows, and the sum over the ranks sits
between fc2 and ``LN_f``.  The same C entry in its partial mode runs the
chain's first seven launches on the slice and returns fc2's f32 sum without
bias or residual, ``part = relu(enc W1 + b1) W2``, and ``enc``; then
``reduce_from_tp`` sums ``part`` over the ranks in f32, and the second entry
(``grit_decode_tail_finish``, one launch) computes ``out = LN_f(enc + (part +
b2)) * pad``.  Plain versions: ``decode_layer_tail_partial_plain`` and
``decode_layer_tail_finish_plain``, of which ``decode_layer_tail_plain`` is the
composition at tp 1.  The split runs forward only (decoding is never
differentiated): on the card it raises where a gradient is asked for.

``weights`` is the 24-tuple in ``_ref``'s order (``LAYER_WEIGHT_ORDER``), each
matrix logically ``[in, out]``.  The kernel reads a matrix as rows of torch's
``Linear`` layout, so it wants ``w.stride(0) == 1``: the transposed view
``linear.weight.t()``, or for a gate one half of it,
``linear.weight[:, :d].t()``; nothing is copied.  The biases of the products
are in the compute dtype, the LayerNorm scales and biases in f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from grit_tpu_torch.ops import _cuda
from grit_tpu_torch.parallel.tensor import reduce_from_tp

#: Kernel launches (one per call that reached the CUDA chain): the whole
#: chain, and the tensor-parallel split's partial and finish entries.
LAUNCHES = {"decode_tail": 0, "decode_tail_partial": 0, "decode_tail_finish": 0}

NEG = -1e30   # additive mask value; exp underflows to exactly 0, like -inf

#: names of the 24 weights, in order (grit_tpu/ops/decode_layer.py::_ref)
LAYER_WEIGHT_ORDER = ("wq1", "bq1", "wo1", "bo1", "ln1s", "ln1b",
                      "wq2", "bq2", "wo2", "bo2", "ln2s", "ln2b",
                      "wsa", "wea", "ba", "wsb", "web", "bb",
                      "wf1", "bf1", "wf2", "bf2", "lnfs", "lnfb")
_MATRICES = (0, 2, 6, 8, 12, 13, 15, 16, 18, 20)
_GATES = (12, 13, 15, 16)
_NORMS = (4, 5, 10, 11, 22, 23)


def _ln(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def decode_layer_tail_partial_plain(x, k1, v1, madd1, k2, v2, madd2, pad, weights, *,
                                    fold: int, n_heads: int, eps: float):
    """Plain version of K11's partial mode: the arguments of
    ``decode_layer_tail_plain`` -> (part, enc), f32 [B*fold, D]: fc2's product
    over the weights' slice of d_ff without its bias, and the gated enc (the
    FFN's input and residual)."""
    (wq1, bq1, wo1, bo1, ln1s, ln1b, wq2, bq2, wo2, bo2, ln2s, ln2b,
     wsa, wea, ba, wsb, web, bb, wf1, bf1, wf2, bf2, lnfs, lnfb) = weights
    b, (rows, d_model) = k1.shape[0], x.shape
    h, d = n_heads, x.shape[-1] // n_heads
    dt = k1.dtype
    xf, xc = x.float(), x.to(dt)

    def cross(k, v, madd, wq, bq, wo, bo, lns, lnb):
        q = (xc @ wq + bq).float() / math.sqrt(d)
        qh = q.to(dt).reshape(b, fold, h, d).permute(0, 2, 1, 3)       # [B, h, f, d]
        kh = k.reshape(b, -1, h, d).permute(0, 2, 3, 1)                # [B, h, d, T]
        vh = v.reshape(b, -1, h, d).permute(0, 2, 1, 3)                # [B, h, T, d]
        s = (qh @ kh).float() + madd[:, None, None, :]
        p = torch.softmax(s, dim=-1)
        o = (p.to(dt) @ vh).permute(0, 2, 1, 3).reshape(rows, d_model)
        return _ln(xf + (o @ wo + bo).float(), lns, lnb, eps)

    enc1 = cross(k1, v1, madd1, wq1, bq1, wo1, bo1, ln1s, ln1b) * pad
    enc2 = cross(k2, v2, madd2, wq2, bq2, wo2, bo2, ln2s, ln2b) * pad

    def gate(ws, we, bg, enc):
        return torch.sigmoid((xc @ ws).float() + (enc.to(dt) @ we).float() + bg.float())

    enc = (enc1 * gate(wsa, wea, ba, enc1) + enc2 * gate(wsb, web, bb, enc2))
    enc = enc * (1.0 / math.sqrt(2)) * pad
    h1 = torch.relu((enc.to(dt) @ wf1).float() + bf1.float())
    return (h1.to(dt) @ wf2).float(), enc


def decode_layer_tail_finish_plain(part, enc, bf2, lnfs, lnfb, pad, *, eps: float,
                                   dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the finish entry: part (the sum over the ranks) and
    enc f32 [R, D], fc2's bias in the compute type, LN_f's f32 scale and bias,
    pad f32 [R, 1] -> LN_f(enc + (part + b2)) * pad in ``dtype``."""
    return (_ln(enc + (part + bf2.float()), lnfs, lnfb, eps) * pad).to(dtype)


def decode_layer_tail_plain(x, k1, v1, madd1, k2, v2, madd2, pad, weights, *, fold: int,
                            n_heads: int, eps: float) -> torch.Tensor:
    """Plain version of K11.  x [B*fold, D]; k_i / v_i [B, T_i, D]; madd_i f32
    [B, T_i] additive; pad f32 [B*fold, 1]; -> [B*fold, D] in x's dtype."""
    part, enc = decode_layer_tail_partial_plain(x, k1, v1, madd1, k2, v2, madd2, pad, weights,
                                                fold=fold, n_heads=n_heads, eps=eps)
    return decode_layer_tail_finish_plain(part, enc, *weights[21:], pad, eps=eps, dtype=x.dtype)


_SMEM_MAX = 232448   # a block's shared memory on Hopper


def attn_smem_bytes(dtype, fold: int, head: int, t_max: int) -> int:
    """Shared memory of the attention launch (``csrc/decode_layer.cu``,
    ``attn_smem``): K and V rows of ``head`` values plus 16 bytes, q, the
    scores (rounded up to 4) and the P V partials of its 8 warps, f32."""
    esize = 2 if dtype == torch.bfloat16 else 4
    ld = head + 16 // esize
    return (2 * t_max * ld * esize
            + (fold * head + (fold * t_max + 3) // 4 * 4 + 8 * fold * head) * 4)


def _launch(x, k1, v1, m1, k2, v2, m2, pad, weights, fold, n_heads, eps, partial=False):
    """Validate a CUDA call and run the chain -> out [B*fold, D] in x's dtype;
    ``partial``: the first seven launches -> (part, enc) f32 [B*fold, D].
    m_i: bool [B, T_i] or None; pad: [B*fold] in x's dtype."""
    rows, d_model = x.shape
    b, t1, _ = k1.shape
    t2 = k2.shape[1]
    dt = x.dtype
    d_ff = weights[18].shape[1]
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"fused_decode_layer_tail: unsupported dtype {dt}")
    if rows != b * fold or d_model % n_heads or d_model % 64 or d_ff % 64:
        raise ValueError(f"fused_decode_layer_tail: {rows} rows for {b} images x fold {fold}, "
                         f"d_model {d_model}, d_ff {d_ff}, {n_heads} heads: needs rows = "
                         "images x fold and widths that are multiples of 64")
    head = d_model // n_heads
    if head % 8 or attn_smem_bytes(dt, fold, head, max(t1, t2)) > _SMEM_MAX:
        raise ValueError(f"fused_decode_layer_tail: head dim {head} (needs a multiple of 8) "
                         f"and fold {fold} x {max(t1, t2)} keys must fit the attention launch's "
                         f"{_SMEM_MAX} bytes of shared memory")
    _cuda.require(x, "x", dt, (rows, d_model))
    _cuda.require(pad, "mask_pad", dt, (rows,))
    for name, t, tk in (("k1", k1, t1), ("v1", v1, t1), ("k2", k2, t2), ("v2", v2, t2)):
        _cuda.require(t, name, dt, (b, tk, d_model))
    for name, m, tk in (("mask1", m1, t1), ("mask2", m2, t2)):
        if m is not None:
            _cuda.require(m, name, torch.bool, (b, tk))
    shapes = {0: (d_model, d_model), 18: (d_model, d_ff), 20: (d_ff, d_model)}
    ldg = weights[12].stride(1)
    for i, w in enumerate(weights):
        name = LAYER_WEIGHT_ORDER[i]
        if not w.is_cuda or w.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned CUDA tensor")
        if i in _MATRICES:
            k_in, n_out = shapes.get(i, shapes[0])
            ld = ldg if i in _GATES else k_in
            if (w.dtype != dt or tuple(w.shape) != (k_in, n_out) or w.stride(0) != 1
                    or w.stride(1) != ld or ld % 8):
                raise ValueError(
                    f"{name}: expected {dt} [{k_in}, {n_out}] as the transposed view of a "
                    f"Linear weight with rows of {ld}, got {w.dtype} {tuple(w.shape)} with "
                    f"strides {w.stride()}")
        else:
            n_out = d_ff if name == "bf1" else d_model
            _cuda.require(w, name, torch.float32 if i in _NORMS else dt, (n_out,))
    lib = _cuda.library()
    out = torch.empty((rows, d_model), dtype=torch.float32 if partial else dt, device=x.device)
    scratch_f = torch.empty((5, rows, d_model), dtype=torch.float32, device=x.device)
    # q, o, h, and the compute-type copies of enc_1, enc_2 and the gated enc
    scratch_t = torch.empty((rows, 7 * d_model + d_ff), dtype=dt, device=x.device)
    ptrs = (ctypes.c_void_p * 24)(*[w.data_ptr() for w in weights])
    _cuda.check(lib.grit_decode_tail(
        x.data_ptr(), k1.data_ptr(), v1.data_ptr(), None if m1 is None else m1.data_ptr(),
        k2.data_ptr(), v2.data_ptr(), None if m2 is None else m2.data_ptr(), pad.data_ptr(),
        out.data_ptr(), ptrs, scratch_f.data_ptr(), scratch_t.data_ptr(), rows, b, fold, t1, t2,
        d_model, d_ff, n_heads, ldg, eps, _cuda.DTYPE_CODE[dt], int(partial), _cuda.stream()),
        "decode_tail_partial" if partial else "decode_tail")
    if partial:
        LAUNCHES["decode_tail_partial"] += 1
        return out, scratch_f[4]
    LAUNCHES["decode_tail"] += 1
    return out


def _launch_finish(part, enc, bf2, lnfs, lnfb, pad, eps) -> torch.Tensor:
    """Validate a CUDA call of the finish entry and launch it -> [R, D] in
    pad's dtype."""
    rows, d_model = part.shape
    dt = pad.dtype
    if dt not in _cuda.DTYPE_CODE or d_model % 64:
        raise ValueError(f"decode_tail_finish: dtype {dt}, width {d_model} (a multiple of 64)")
    for name, t, t_dt, shape in (("part", part, torch.float32, (rows, d_model)),
                                 ("enc", enc, torch.float32, (rows, d_model)),
                                 ("bf2", bf2, dt, (d_model,)),
                                 ("lnfs", lnfs, torch.float32, (d_model,)),
                                 ("lnfb", lnfb, torch.float32, (d_model,)),
                                 ("mask_pad", pad, dt, (rows,))):
        _cuda.require(t, name, t_dt, shape)
    out = torch.empty((rows, d_model), dtype=dt, device=part.device)
    _cuda.check(_cuda.library().grit_decode_tail_finish(
        part.data_ptr(), enc.data_ptr(), bf2.data_ptr(), lnfs.data_ptr(), lnfb.data_ptr(),
        pad.data_ptr(), out.data_ptr(), rows, d_model, eps, _cuda.DTYPE_CODE[dt],
        _cuda.stream()), "decode_tail_finish")
    LAUNCHES["decode_tail_finish"] += 1
    return out


def additive_mask(mask: Optional[torch.Tensor], b: int, t: int, device) -> torch.Tensor:
    """bool [B, T] (True = masked) or None -> the f32 additive mask [B, T]."""
    if mask is None:
        return torch.zeros((b, t), dtype=torch.float32, device=device)
    return torch.where(mask.reshape(b, t), NEG, 0.0).float()


class _TailFn(torch.autograd.Function):
    """K11 forward; the backward recomputes through the plain version and
    differentiates it (x, the four K/V tensors and the weights)."""

    @staticmethod
    def forward(ctx, fold, n_heads, eps, x, k1, v1, m1, k2, v2, m2, pad, *weights):
        ctx.args = (fold, n_heads, eps)
        ctx.save_for_backward(x, k1, v1, m1, k2, v2, m2, pad, *weights)
        b = k1.shape[0]
        if x.device.type == "cpu":
            return decode_layer_tail_plain(
                x, k1, v1, additive_mask(m1, b, k1.shape[1], x.device), k2, v2,
                additive_mask(m2, b, k2.shape[1], x.device), pad.float()[:, None], weights,
                fold=fold, n_heads=n_heads, eps=eps)
        return _launch(x, k1, v1, m1, k2, v2, m2, pad, weights, fold, n_heads, eps)

    @staticmethod
    def backward(ctx, dy):
        fold, n_heads, eps = ctx.args
        x, k1, v1, m1, k2, v2, m2, pad, *weights = ctx.saved_tensors
        b = k1.shape[0]
        tensors = [x, k1, v1, k2, v2, *weights]
        wanted = [ctx.needs_input_grad[i] for i in (3, 4, 5, 7, 8)] + list(
            ctx.needs_input_grad[11:])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w) for t, w in zip(tensors, wanted)]
            lx, lk1, lv1, lk2, lv2, *lw = leaves
            out = decode_layer_tail_plain(
                lx, lk1, lv1, additive_mask(m1, b, k1.shape[1], x.device), lk2, lv2,
                additive_mask(m2, b, k2.shape[1], x.device), pad.float()[:, None], lw,
                fold=fold, n_heads=n_heads, eps=eps)
            grads = torch.autograd.grad(out, [t for t, w in zip(leaves, wanted) if w], dy)
        it = iter(grads)
        g = [next(it) if w else None for w in wanted]
        return (None, None, None, g[0], g[1], g[2], None, g[3], g[4], None, None, *g[5:])


def fused_decode_layer_tail(x, k1, v1, mask1, k2, v2, mask2, mask_pad,
                            weights: Sequence[torch.Tensor], *, fold: int, n_heads: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """K11: the decode layer's tail after self-attention (module docstring).

    x: [B*fold, 1, D], the self-attention output, rows of one image
    consecutive; k_i / v_i: [B, T_i, D] projected visual K/V; mask_i: bool
    [B, 1, 1, T_i] (True = masked) or None; mask_pad: [B*fold, 1, 1];
    weights: 24-tuple (``LAYER_WEIGHT_ORDER``).  Returns [B*fold, 1, D].  CPU
    tensors run the plain version; CUDA tensors launch the kernels or raise."""
    rows = x.shape[0]
    b = k1.shape[0]
    m1 = None if mask1 is None else mask1.reshape(b, k1.shape[1])
    m2 = None if mask2 is None else mask2.reshape(b, k2.shape[1])
    out = _TailFn.apply(fold, n_heads, eps, x.reshape(rows, -1), k1, v1, m1, k2, v2, m2,
                        mask_pad.reshape(rows).to(x.dtype), *weights)
    return out[:, None, :]


def decode_tail_partial(x, k1, v1, mask1, k2, v2, mask2, mask_pad,
                        weights: Sequence[torch.Tensor], *, fold: int, n_heads: int,
                        eps: float = 1e-5):
    """K11's partial entry on a rank's slice of d_ff (the weights' fc1 / fc2
    are the slices): x [B*fold, D] (or [B*fold, 1, D]), masks and pad as
    ``fused_decode_layer_tail`` -> (part, enc) f32 [B*fold, D].  CPU tensors
    run the plain version; CUDA tensors launch the first seven kernels or
    raise.  Forward only."""
    rows = x.shape[0]
    b = k1.shape[0]
    m1 = None if mask1 is None else mask1.reshape(b, k1.shape[1])
    m2 = None if mask2 is None else mask2.reshape(b, k2.shape[1])
    x2 = x.reshape(rows, -1)
    pad = mask_pad.reshape(rows).to(x.dtype)
    if x.device.type == "cpu":
        return decode_layer_tail_partial_plain(
            x2, k1, v1, additive_mask(m1, b, k1.shape[1], x.device), k2, v2,
            additive_mask(m2, b, k2.shape[1], x.device), pad.float()[:, None], weights,
            fold=fold, n_heads=n_heads, eps=eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, k1, v1, k2, v2, *weights)):
        raise RuntimeError("decode_tail_partial: the split tail has no backward; decode "
                           "under torch.no_grad()")
    return _launch(x2, k1, v1, m1, k2, v2, m2, pad, weights, fold, n_heads, eps, partial=True)


def decode_tail_finish(part, enc, bf2, lnfs, lnfb, mask_pad, *, eps: float = 1e-5,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K11's finish entry: part (the f32 sum over the ranks of
    ``decode_tail_partial``'s part) and its enc -> LN_f(enc + (part + b2)) *
    pad [R, D] in ``dtype`` (default: mask_pad's).  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    rows = part.shape[0]
    pad = mask_pad.reshape(rows).to(dtype or mask_pad.dtype)
    if part.device.type == "cpu":
        return decode_layer_tail_finish_plain(part, enc, bf2, lnfs, lnfb, pad.float()[:, None],
                                              eps=eps, dtype=pad.dtype)
    return _launch_finish(part, enc, bf2, lnfs, lnfb, pad, eps)


def fused_decode_layer_tail_tp(x, k1, v1, mask1, k2, v2, mask2, mask_pad,
                               weights: Sequence[torch.Tensor], *, fold: int, n_heads: int,
                               group, eps: float = 1e-5) -> torch.Tensor:
    """K11 split around the FFN's reduction over the tensor group ``group``
    (module docstring): ``decode_tail_partial`` on this rank's slice of d_ff,
    the f32 all-reduce, ``decode_tail_finish``.  Arguments and result as
    ``fused_decode_layer_tail``."""
    part, enc = decode_tail_partial(x, k1, v1, mask1, k2, v2, mask2, mask_pad, weights,
                                    fold=fold, n_heads=n_heads, eps=eps)
    out = decode_tail_finish(reduce_from_tp(part, group), enc, *weights[21:], mask_pad,
                             eps=eps, dtype=x.dtype)
    return out[:, None, :]
