"""Plain layers of the reference, in float32, and the arithmetic they run in.

Every product of the reference (linear layers, convolutions, the attention
products) goes through one ``Arith`` object.  ``Arith("fp32")`` is the
reference: float32 with TF32 off.  ``Arith("fp8")`` is the control of a
bfloat16 configuration: both operands of every product (and in a
backward, the incoming gradient) are rounded to float8 e4m3 with a
per-tensor scale (the tensor's absolute maximum onto 448, the format's
largest value) and multiplied in float32, as an fp8 product with float32
accumulation computes it.  ``Arith("tf32")`` is the control of a float32
configuration: the same with TF32's rounding (10 mantissa bits, to nearest
even), as the tensor cores' TF32 products read their operands.  A
convolution's operands are rounded alike, its gradient passed through.

This file imports only torch: the reference reads weights by the names of
the model's state dict, and nothing of the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8_parts(t: torch.Tensor):
    """``t`` in float8 e4m3 under a per-tensor scale -> (fp8 tensor, scale)."""
    with torch.no_grad():
        t = t.detach().float()
        amax = t.abs().amax()
        scale = amax / FP8_MAX if torch.isfinite(amax) and amax > 0 else torch.ones_like(amax)
        return (t / scale).to(torch.float8_e4m3fn), scale


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    q, scale = fp8_parts(t)
    return q.float() * scale


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10 mantissa bits (to nearest, ties to even),
    in float32."""
    i = t.detach().float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _pack(t: torch.Tensor, mode: str):
    """An operand as a product of ``mode`` reads it, kept compactly: fp8
    values with their scale, or TF32-rounded float32."""
    if mode == "fp8":
        return fp8_parts(t)
    return tf32_round(t), torch.ones((), device=t.device)


def _unpack(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class _Product(torch.autograd.Function):
    """a b^T (``linear``) or a b (batched alike) with both operands, and in
    the backward the incoming gradient, rounded to the precision of ``mode``
    ("tf32" or "fp8") and multiplied in float32.  The operands are kept in
    that precision for the backward (a byte an element in fp8)."""

    @staticmethod
    def forward(ctx, a, b, mode: str, linear: bool):
        pa, pb = _pack(a, mode), _pack(b, mode)
        ctx.save_for_backward(*pa, *pb)
        ctx.mode, ctx.linear = mode, linear
        a, b = _unpack(*pa), _unpack(*pb)
        return F.linear(a, b) if linear else a @ b

    @staticmethod
    def backward(ctx, g):
        qa, sa, qb, sb = ctx.saved_tensors
        a, b = _unpack(qa, sa), _unpack(qb, sb)
        g = _unpack(*_pack(g, ctx.mode))
        if ctx.linear:
            gb = g.reshape(-1, g.shape[-1]).t() @ a.reshape(-1, a.shape[-1])
            return g @ b, gb, None, None
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g, None, None


def _through(t: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded`` in the forward, the identity's gradient in the backward."""
    return t + (rounded - t).detach() if t.requires_grad else rounded


class Arith:
    """The precision of the reference's products: "fp32", "tf32" or "fp8"."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"Arith: unknown mode {mode!r}")
        self.mode = mode

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.mode in ("fp8", "tf32"):
            return _through(t, _unpack(*_pack(t, self.mode)))
        return t

    def linear(self, x, w, b=None):
        if self.mode in ("fp8", "tf32"):
            y = _Product.apply(x.float(), w.float(), self.mode, True)
            return y if b is None else y + b.float()
        return F.linear(self._q(x), self._q(w), None if b is None else b.float())

    def matmul(self, a, b):
        if self.mode in ("fp8", "tf32"):
            return _Product.apply(a.float(), b.float(), self.mode, False)
        return self._q(a) @ self._q(b)

    def conv2d(self, x, w, b=None, stride: int = 1):
        return F.conv2d(self._q(x), self._q(w), None if b is None else b.float(), stride=stride)


def fp32_context():
    """Turn TF32 off for the reference's float32 products on a card; returns
    the previous settings for ``restore``."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return prev


def restore(prev) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def layer_norm(x, P, name: str, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], eps)


def group_norm(x, P, name: str, groups: int, eps: float = 1e-5):
    return F.group_norm(x.float(), groups, P[name + ".weight"], P[name + ".bias"], eps)


def dense(A: Arith, x, P, name: str, bias: bool = True):
    return A.linear(x, P[name + ".weight"], P[name + ".bias"] if bias else None)


def attention(A: Arith, q, k, v, n_heads: int, mask=None, drop=None):
    """Scaled dot-product attention of q [B, Nq, C] over k, v [B, Nk, C] in
    ``n_heads`` heads; ``mask`` bool, True = masked out, broadcast to [B,
    heads, Nq, Nk]; ``drop`` on the probabilities."""
    b, nq, c = q.shape
    d = c // n_heads

    def heads(t):
        return t.reshape(b, t.shape[1], n_heads, d).transpose(1, 2)

    s = A.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(d)
    if mask is not None:
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, -1)
    o = A.matmul(p if drop is None else drop(p), heads(v))
    return o.transpose(1, 2).reshape(b, nq, c)


def identity(x):
    return x


def mha(A: Arith, P, name: str, q, k, v, n_heads: int, mask=None, drop=identity):
    """The caption stack's post-LN attention block: LN(q + drop(fc_o(attn(fc_q
    q, fc_k k, fc_v v)))), ``drop`` also on the attention probabilities."""
    a = name + ".attention"
    o = attention(A, dense(A, q, P, a + ".fc_q"), dense(A, k, P, a + ".fc_k"),
                  dense(A, v, P, a + ".fc_v"), n_heads, mask, drop=drop)
    return layer_norm(q + drop(dense(A, o, P, a + ".fc_o")), P, name + ".layer_norm")


def ffn(A: Arith, P, name: str, x, drop=identity):
    """LN(x + drop(fc2(drop(relu(fc1 x)))))."""
    h = drop(F.relu(dense(A, x, P, name + ".fc1")))
    return layer_norm(x + drop(dense(A, h, P, name + ".fc2")), P, name + ".layer_norm")
