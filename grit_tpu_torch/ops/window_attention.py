"""Swin kernels: K1 (attention half-block), K2 (MLP half-block), K4 (the
training block's attention branch), K5 (window-attention backward), K8 (the
window-attention core on a dense bias), K10a (PatchMerging's LayerNorm +
reduction) and K10b (the patch-embed LayerNorm).

``block_step`` replaces the TPU's ``grit_tpu/ops/window_attention.py``
``_band_kernel`` (via ``fused_block_step`` / ``fused_block_mlp_step``),
``mlp`` its ``_mlp_kernel`` (via ``fused_mlp``), ``block_attention`` its
``_block_kernel`` (via ``fused_block_attention``, with ``save_attn`` the
differentiating forward) and ``window_attention_bwd`` its ``_bwd_kernel``
(via ``_backward``; bf16 on ``csrc/win_attn_bwd_mma.cu``, fp32 on
``csrc/win_attn_f32.cu``).  On a CUDA tensor
each launches the hand-written kernels in ``csrc/swin_block.cu`` (design notes
there) or raises; on a CPU tensor each runs its plain version (``*_plain``),
which defines the dtype semantics the kernels reproduce: f32 LN statistics
with var = E[x^2] - mu^2, f32 matmul accumulation, q scaled before rounding
to the storage type, softmax probabilities rounded to the storage type before
the value product (and, in the backward, the score gradient times the scale
rounded before the q and k products), exact-erf GELU, residuals added in
f32.

Two kernels do most of the work inside them, each launched by one helper
here: ``gemm`` (every product of K1, K2, K4 and K10a; bf16 on
``csrc/gemm_sm90.cu``) and ``attention_core`` (the attention core of K1 and
K4, and K8's forward; bf16 on ``csrc/window_attn_mma.cu``, fp32 on
``csrc/win_attn_f32.cu``); ``gemm_plain``
and ``attention_core_plain`` are their plain versions.

``window_attention`` replaces its ``_kernel`` and, for the gradient, its
``_bwd_kernel`` on a dense bias (via ``fused_window_attention``);
``ln_linear`` / ``patch_merge`` its ``_lnlin_kernel`` (via ``fused_ln_linear``)
and ``layernorm_rows`` its ``_ln_kernel`` (via ``fused_layernorm``).

``block_attention_train`` and ``mlp`` are differentiable
(``torch.autograd.Function``): the attention branch's backward runs K5 for
the attention core and plain matrix products for the projections, as the
TPU's ``_block_attention_bwd`` does; the MLP's backward recomputes the
branch's pre-activation from its row input, as ``_mlp_bwd`` does, and takes
the gradient of ``_mlp_recompute`` with plain matrix products around two
passes of its own (``gelu_bwd`` over the hidden rows, ``ln_rows_bwd`` over
the rows; ``_mlp_backward``).  Gradients come back in each argument's
dtype.

Unlike the TPU path, the map is never rolled: the blocks take and return the
padded map [B, Hp, Wp, C] in unshifted coordinates, and the kernels fold the
shift into their addresses.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from grit_tpu_torch.ops import _cuda
from grit_tpu_torch.ops.window import (relative_position_gather, relative_position_index,
                                       shifted_window_mask, window_partition,
                                       window_reverse)

LN_EPS = 1e-5

#: Kernel launches per wrapper (one per call that reached the CUDA kernels),
#: and of the GEMM, the attention core and its backward inside them, by
#: storage type.
LAUNCHES = {"block_step": 0, "mlp": 0, "block_attention": 0, "window_attention_bwd": 0,
            "window_attention": 0, "window_attention_grad": 0, "ln_linear": 0,
            "layernorm_rows": 0, "gemm_bf16": 0, "gemm_f32": 0, "win_attn_bf16": 0,
            "win_attn_f32": 0, "win_attn_bwd_bf16": 0, "win_attn_bwd_f32": 0,
            "mlp_bwd": 0, "gelu_bwd_bf16": 0, "gelu_bwd_f32": 0, "ln_rows_bwd_bf16": 0,
            "ln_rows_bwd_f32": 0}

#: the GEMM's epilogues (csrc/common.cuh)
EPILOGUES = {"bias": 0, "gelu": 1, "resid": 2, "resid_map": 3, "map": 4}
#: (N, K) multiples that the GEMM kernels take: bf16's wgmma kernel
#: (128-column tiles, 64-deep K steps) zero-fills its tiles beyond N and K,
#: and needs N and K in whole 16-byte rows and 8-column epilogue lanes; fp32's
#: SIMT kernel masks its 128- or 64-column tiles in whole float4s over
#: 16-deep K steps.  Every product of the five Swin presets meets both
GEMM_TILES = {torch.bfloat16: (8, 8), torch.float32: (4, 16)}
#: values in one 16-byte chunk of the LayerNorm kernels (ln_rows_kernel,
#: ln_merge_kernel): they read and write a row in whole chunks, and a row
#: takes at most 256 lanes of 6 chunks: ``LN_MAX_WIDTH`` values.  Every LN
#: width of the Swin presets (C, and 4C in PatchMerging) is whole chunks in
#: both types, the widest (fp32 4C = 6144) the most
LN_CHUNK = {torch.bfloat16: 8, torch.float32: 4}
LN_MAX_WIDTH = {torch.bfloat16: 12288, torch.float32: 6144}
#: K5 takes windows up to 12 (N <= 144), odd ones too: the bf16 kernel's two
#: N x N bf16 tiles and its double-buffered rows, and the fp32 kernel's Q, K,
#: V, dO and N x N f32 tile, fill a block's 227 KB of shared memory.  K8's
#: backward, on no model path, reads its dense bias in pairs (or fours) of
#: columns and keeps N % 4 == 0
_MAX_BWD_WINDOW = 12
#: both backward kernels run one block an SM; each splits the batch into
#: chunks (one block each) until a launch has about this many waves of blocks
_BWD_WAVES = 2


def _dtype_name(dt) -> str:
    return "bf16" if dt == torch.bfloat16 else "f32"


def check_gemm_shape(n_out: int, k_in: int, dtype, what: str = "gemm") -> None:
    """Raise ``ValueError`` unless the GEMM kernel of ``dtype`` takes a
    product [M, k_in] x [n_out, k_in]^T (``GEMM_TILES``).  Every wrapper
    checks each product it launches with this before it launches."""
    if dtype not in GEMM_TILES:
        raise ValueError(f"{what}: unsupported dtype {dtype}")
    tn, tk = GEMM_TILES[dtype]
    if n_out <= 0 or k_in <= 0 or n_out % tn or k_in % tk:
        raise ValueError(f"{what}: the {_dtype_name(dtype)} GEMM does not take a product of "
                         f"{k_in} -> {n_out} columns (out % {tn}, in % {tk})")


def check_ln_shape(c: int, dtype, what: str = "layernorm") -> None:
    """Raise ``ValueError`` unless the LayerNorm kernels of ``dtype`` take
    rows of ``c`` values (``LN_CHUNK``; for PatchMerging's norm ``c`` is the
    map's channels).  Every wrapper that launches one checks its width with
    this before any launch; ``_cuda.require`` checks that each tensor is
    16-byte aligned."""
    if dtype not in LN_CHUNK:
        raise ValueError(f"{what}: unsupported dtype {dtype}")
    v, most = LN_CHUNK[dtype], LN_MAX_WIDTH[dtype]
    if c <= 0 or c % v or c > most:
        raise ValueError(f"{what}: the {_dtype_name(dtype)} LayerNorm kernels take rows of whole "
                         f"16-byte chunks of {v} values, at most {most} values; got {c} values")


def _ln_fast(xf: torch.Tensor, w, b, eps: float) -> torch.Tensor:
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def _pad_mask(hp: int, wp: int, real_hw, shift: int, device) -> torch.Tensor:
    """[Hp, Wp, 1] bool: True on window-padding tokens, in coordinates of the
    map rolled by -shift."""
    y = (torch.arange(hp, device=device) + shift) % hp
    x = (torch.arange(wp, device=device) + shift) % wp
    return ((y[:, None] >= real_hw[0]) | (x[None, :] >= real_hw[1]))[..., None]


def _qkv_plain(xw, qkv_w, qkv_b, num_heads: int) -> torch.Tensor:
    """Window-ordered rows [R, C] -> qkv [R, 3C] in the rows' dtype, the q
    columns scaled by d^-1/2 before rounding (f32 accumulation)."""
    c = xw.shape[-1]
    qkv = F.linear(xw.float(), qkv_w.float(), qkv_b.float())
    scale = torch.ones(3 * c, device=xw.device)
    scale[:c] = (c // num_heads) ** -0.5
    return (qkv * scale).to(xw.dtype)


def _heads(t: torch.Tensor, n: int, num_heads: int) -> torch.Tensor:
    """Window-order rows [B*nW*N, C] -> f32 [B*nW, heads, N, C / heads]."""
    return t.float().reshape(-1, n, num_heads, t.shape[-1] // num_heads).transpose(1, 2)


def _scores(q, k, table, *, batch: int, hp: int, wp: int, window: int, shift: int):
    """S = q k^T + the relative-position bias (+ the shifted-window mask), f32
    [B*nW, heads, N, N] from q, k [B*nW, heads, N, d]."""
    n, num_heads = window * window, q.shape[1]
    s = q @ k.transpose(-1, -2)
    idx = relative_position_index(window, q.device)
    s = s + table.float()[idx.reshape(-1)].reshape(n, n, num_heads).permute(2, 0, 1)
    if shift:
        mask = shifted_window_mask(hp, wp, window, shift, q.device)  # [nW, N, N]
        s = (s.reshape(batch, -1, num_heads, n, n) + mask[None, :, None]).reshape(s.shape)
    return s


def attention_core_plain(qkv, table, *, batch: int, hp: int, wp: int, num_heads: int,
                           window: int, shift: int = 0) -> torch.Tensor:
    """Plain version of the window-attention core: qkv [B*nW*N, 3C] in
    window order (q pre-scaled) -> attention output [B*nW*N, C] in qkv's
    dtype.  The bias comes from its [(2w-1)^2, heads] table, the
    shifted-window mask from the padded grid."""
    c = qkv.shape[-1] // 3
    n = window * window
    q, k, v = (_heads(qkv[:, i * c:(i + 1) * c], n, num_heads) for i in range(3))
    s = _scores(q, k, table, batch=batch, hp=hp, wp=wp, window=window, shift=shift)
    p = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    return (p @ v).transpose(1, 2).reshape(-1, c).to(qkv.dtype)


def attention_core(qkv, table, *, batch: int, hp: int, wp: int, num_heads: int, window: int,
                   shift: int = 0, out=None) -> torch.Tensor:
    """One launch of the window-attention core (see ``attention_core_plain``)
    on qkv [B*nW*N, 3C] in window order; ``out`` [B*nW*N, C] may be given.
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if qkv.device.type == "cpu":
        return attention_core_plain(qkv, table, batch=batch, hp=hp, wp=wp,
                                    num_heads=num_heads, window=window, shift=shift)
    rows, c3 = qkv.shape
    c = c3 // 3
    dt = qkv.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"attention_core: unsupported dtype {dt}")
    if c != 32 * num_heads:
        raise ValueError(f"attention_core: head dim must be 32, got {c}/{num_heads}")
    if hp % window or wp % window or window * window > 256 or rows != batch * hp * wp:
        raise ValueError(f"attention_core: {rows} rows for {batch} maps of {hp}x{wp} in "
                         f"windows of {window}")
    _cuda.require(qkv, "qkv", dt, (rows, 3 * c))
    _cuda.require(table, "table", torch.float32, ((2 * window - 1) ** 2, num_heads))
    if out is None:
        out = torch.empty((rows, c), dtype=dt, device=qkv.device)
    _cuda.require(out, "out", dt, (rows, c))
    _cuda.check(_cuda.library().grit_window_attn(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(), rows // (window * window), c,
        num_heads, hp, wp, window, shift, _cuda.DTYPE_CODE[dt], _cuda.stream()),
        "attention_core")
    LAUNCHES["win_attn_" + _dtype_name(dt)] += 1
    return out


def _window_tokens(rows: int, geo) -> torch.Tensor:
    """The flat index in the unshifted map of the token of each window-order
    row, for ``rows`` map tokens of geometry ``geo`` = (Hp, Wp, window,
    shift, real_h, real_w)."""
    hp, wp, window, shift = geo[:4]
    return _to_windows(torch.arange(rows).reshape(-1, hp, wp, 1), window, shift).reshape(-1)


def gemm_plain(a, w, bias=None, *, epilogue: str = "bias", scale: float = 1.0,
               scale_cols: int = 0, resid=None, geo=None, gather: bool = False) -> torch.Tensor:
    """Plain version of the Swin GEMM: out = epilogue(a w^T + bias), f32
    accumulation and epilogue, one rounding to a's dtype.

    a: rows [M, K], or with ``gather`` the map [B, Hp, Wp, K] read in window
    order (row r from the token of window-order row r); w: [N, K]; bias: [N]
    or None.  ``epilogue``: "bias" (columns < ``scale_cols`` times
    ``scale``), "gelu" (exact erf), "resid" (+ ``resid`` [M, N]),
    "resid_map" (window-order rows stored at their tokens of the map, + the
    map ``resid`` at tokens that are not window padding) or "map" (stored at
    their tokens).  ``geo``: (Hp, Wp, window, shift, real_h, real_w) of the
    map for ``gather`` and the map epilogues, which return [B*Hp*Wp, N]."""
    dt = a.dtype
    if gather:
        a = _to_windows(a, geo[2], geo[3])
    y = F.linear(a.float(), w.float(), None if bias is None else bias.float())
    if epilogue == "bias":
        if scale_cols:
            y[:, :scale_cols] *= scale
    elif epilogue == "gelu":
        y = y * 0.5 * (1.0 + torch.erf(y * 0.7071067811865476))
    elif epilogue == "resid":
        y = y + resid.float()
    elif epilogue in ("resid_map", "map"):
        y = torch.empty_like(y).index_copy_(0, _window_tokens(y.shape[0], geo).to(y.device), y)
        if epilogue == "resid_map":
            hp, wp, _, _, real_h, real_w = geo
            t = torch.arange(y.shape[0], device=y.device)
            pad = ((t // wp) % hp >= real_h) | (t % wp >= real_w)
            y = y + resid.reshape(y.shape).float().masked_fill(pad[:, None], 0.0)
    else:
        raise ValueError(f"gemm: unknown epilogue {epilogue!r}")
    return y.to(dt)


def gemm(a, w, bias=None, *, epilogue: str = "bias", scale: float = 1.0, scale_cols: int = 0,
         resid=None, geo=None, gather: bool = False) -> torch.Tensor:
    """One launch of the Swin GEMM (see ``gemm_plain``), [M, N] with M =
    a.numel() / K.  CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, epilogue=epilogue, scale=scale, scale_cols=scale_cols,
                          resid=resid, geo=geo, gather=gather)
    dt = a.dtype
    n_out, k_in = w.shape
    check_gemm_shape(n_out, k_in, dt)
    m = a.numel() // k_in
    if a.shape[-1] != k_in:
        raise ValueError(f"gemm: A of shape {tuple(a.shape)} for a weight over {k_in}")
    if (gather or epilogue in ("resid_map", "map")) and geo is None:
        raise ValueError(f"gemm: {epilogue} / gather needs the map's geometry")
    _cuda.require(a, "a", dt)
    _cuda.require(w, "w", dt, (n_out, k_in))
    if bias is not None:
        _cuda.require(bias, "bias", dt, (n_out,))
    if resid is not None:
        _cuda.require(resid, "resid", dt)
        if resid.numel() != m * n_out:
            raise ValueError(f"gemm: residual of {resid.numel()} elements for {m} x {n_out}")
    elif epilogue in ("resid", "resid_map"):
        raise ValueError(f"gemm: epilogue {epilogue} needs a residual")
    out = torch.empty((m, n_out), dtype=dt, device=a.device)
    _cuda.check(_cuda.library().grit_gemm(
        a.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if resid is None else resid.data_ptr(), m, n_out, k_in, EPILOGUES[epilogue],
        scale, scale_cols, *(geo or (1, 1, 1, 0, 1, 1)), int(gather), _cuda.DTYPE_CODE[dt],
        _cuda.stream()), f"gemm ({epilogue})")
    LAUNCHES["gemm_" + _dtype_name(dt)] += 1
    return out


def block_step_plain(x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b, table, *,
                     num_heads: int, window: int, real_hw, shift: int = 0,
                     eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of K1: x + proj(W-MSA(LN1(x))) on the padded map.

    x: [B, Hp, Wp, C]; tokens outside ``real_hw`` are window padding (zero
    before the LN statistics and after the affine; no residual).  Linear
    weights in torch layout [out, in]; ``table``: [(2w-1)^2, heads].
    Output at padding tokens is unspecified (finite).  The kernels take the
    Linear weights and biases in x's dtype and the norm parameters and the
    table in f32, as ``models.captioner.to_compute_dtype`` stores them.
    """
    b, hp, wp, c = x.shape
    n = window * window
    dt = x.dtype
    xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    pad = _pad_mask(hp, wp, real_hw, shift, x.device)
    xf = xs.float().masked_fill(pad, 0.0)
    xn = _ln_fast(xf, norm_w, norm_b, eps).masked_fill(pad, 0.0).to(dt)
    qkv = _qkv_plain(window_partition(xn, window).reshape(-1, c), qkv_w, qkv_b, num_heads)
    o = attention_core_plain(qkv, table, batch=b, hp=hp, wp=wp, num_heads=num_heads,
                               window=window, shift=shift)
    y = F.linear(o.float(), proj_w.float(), proj_b.float()).reshape(-1, n, c)
    y = window_reverse(y, window, hp, wp) + xf
    y = y.to(dt)
    return torch.roll(y, (shift, shift), (1, 2)) if shift else y


def block_step(x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b, table, *,
               num_heads: int, window: int, real_hw, shift: int = 0,
               eps: float = LN_EPS) -> torch.Tensor:
    """K1: one Swin attention half-block on the padded map (see
    ``block_step_plain``).  CPU tensors run the plain version; CUDA tensors
    launch the kernels or raise.

    It also serves the TPU's ``_step_kernel`` (K9, the ``GRIT_WA_BAND=0``
    layout of the same function, ``_step_forward``): that body and
    ``_band_kernel`` differ only in how many windows share one VMEM-resident
    band of the map, a choice the GPU does not have to make (a block of
    threads owns one (window, head) and the map stays in device memory), so
    one set of launches computes both."""
    if x.device.type == "cpu":
        return block_step_plain(
            x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b, table,
            num_heads=num_heads, window=window, real_hw=real_hw, shift=shift, eps=eps)
    b, hp, wp, c = x.shape
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"block_step: unsupported dtype {dt}")
    if c != 32 * num_heads:
        raise ValueError(f"block_step: head dim must be 32, got {c}/{num_heads}")
    if hp % window or wp % window or window * window > 256:
        raise ValueError(f"block_step: map {hp}x{wp} does not tile windows of {window}")
    check_ln_shape(c, dt, "block_step ln1")
    check_gemm_shape(3 * c, c, dt, "block_step qkv")
    check_gemm_shape(c, c, dt, "block_step proj")
    for t, name, t_dt, shape in (
            (x, "x", dt, None), (qkv_w, "qkv_w", dt, (3 * c, c)), (qkv_b, "qkv_b", dt, (3 * c,)),
            (proj_w, "proj_w", dt, (c, c)), (proj_b, "proj_b", dt, (c,)),
            (norm_w, "norm_w", torch.float32, (c,)), (norm_b, "norm_b", torch.float32, (c,)),
            (table, "table", torch.float32, ((2 * window - 1) ** 2, num_heads))):
        _cuda.require(t, name, t_dt, shape)
    lib = _cuda.library()
    code = _cuda.DTYPE_CODE[dt]
    st = _cuda.stream()
    rows = b * hp * wp
    geo = (hp, wp, window, shift, int(real_hw[0]), int(real_hw[1]))

    xn = torch.empty((rows, c), dtype=dt, device=x.device)
    _cuda.check(lib.grit_ln_rows(x.data_ptr(), norm_w.data_ptr(), norm_b.data_ptr(),
                                 xn.data_ptr(), rows, c, 1, *geo, eps, code, st),
                "block_step ln1")
    qkv = gemm(xn, qkv_w, qkv_b, scale=(c // num_heads) ** -0.5, scale_cols=c)
    # xn is dead once qkv exists: the attention output takes its place
    ao = attention_core(qkv, table, batch=b, hp=hp, wp=wp, num_heads=num_heads,
                        window=window, shift=shift, out=xn)
    out = gemm(ao, proj_w, proj_b, epilogue="resid_map", resid=x, geo=geo).reshape(x.shape)
    LAUNCHES["block_step"] += 1
    return out


def _to_windows(x: torch.Tensor, window: int, shift: int) -> torch.Tensor:
    """Map [B, Hp, Wp, C] in unshifted coordinates -> window-ordered rows
    [B*nW*N, C] of the map rolled by -shift."""
    xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    return window_partition(xs, window).reshape(-1, x.shape[-1])


def _from_windows(rows: torch.Tensor, window: int, shift: int, hp: int, wp: int) -> torch.Tensor:
    """Inverse of ``_to_windows``."""
    n = window * window
    y = window_reverse(rows.reshape(-1, n, rows.shape[-1]), window, hp, wp)
    return torch.roll(y, (shift, shift), (1, 2)) if shift else y


def block_attention_plain(x, qkv_w, qkv_b, proj_w, proj_b, table, *, num_heads: int,
                          window: int, shift: int = 0):
    """Plain version of K4: proj(W-MSA(x)) on the LayerNorm'd, zero-padded
    map x [B, Hp, Wp, C] in unshifted coordinates; every token takes part, as
    in the reference (padding tokens are zero rows, not masked).  Returns
    (branch [B, Hp, Wp, C], pre-projection attention output [B*nW*N, C] in
    window order, qkv [B*nW*N, 3C])."""
    b, hp, wp, c = x.shape
    qkv = _qkv_plain(_to_windows(x, window, shift), qkv_w, qkv_b, num_heads)
    ao = attention_core_plain(qkv, table, batch=b, hp=hp, wp=wp, num_heads=num_heads,
                                window=window, shift=shift)
    y = F.linear(ao.float(), proj_w.float(), proj_b.float()).to(x.dtype)
    return _from_windows(y, window, shift, hp, wp), ao, qkv


def _block_attention(x, qkv_w, qkv_b, proj_w, proj_b, table, *, num_heads: int, window: int,
                     shift: int):
    """K4 with everything its backward wants: (branch, attention output, qkv)."""
    if x.device.type == "cpu":
        return block_attention_plain(x, qkv_w, qkv_b, proj_w, proj_b, table,
                                     num_heads=num_heads, window=window, shift=shift)
    b, hp, wp, c = x.shape
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"block_attention: unsupported dtype {dt}")
    if c != 32 * num_heads:
        raise ValueError(f"block_attention: head dim must be 32, got {c}/{num_heads}")
    if hp % window or wp % window or window * window > 256:
        raise ValueError(f"block_attention: map {hp}x{wp} does not tile windows of {window}")
    check_gemm_shape(3 * c, c, dt, "block_attention qkv")
    check_gemm_shape(c, c, dt, "block_attention proj")
    for t, name, t_dt, shape in (
            (x, "x", dt, None), (qkv_w, "qkv_w", dt, (3 * c, c)), (qkv_b, "qkv_b", dt, (3 * c,)),
            (proj_w, "proj_w", dt, (c, c)), (proj_b, "proj_b", dt, (c,)),
            (table, "table", torch.float32, ((2 * window - 1) ** 2, num_heads))):
        _cuda.require(t, name, t_dt, shape)
    rows = b * hp * wp
    geo = (hp, wp, window, shift, hp, wp)   # no token is padding to this kernel
    qkv = gemm(x, qkv_w, qkv_b, scale=(c // num_heads) ** -0.5, scale_cols=c, geo=geo,
               gather=True)
    ao = attention_core(qkv, table, batch=b, hp=hp, wp=wp, num_heads=num_heads,
                        window=window, shift=shift)
    out = gemm(ao, proj_w, proj_b, epilogue="map", geo=geo).reshape(x.shape)
    LAUNCHES["block_attention"] += 1
    return out, ao, qkv


def block_attention(x, qkv_w, qkv_b, proj_w, proj_b, table, *, num_heads: int, window: int,
                    shift: int = 0, save_attn: bool = False):
    """K4: the training block's attention branch (see ``block_attention_plain``):
    qkv projection, window partition, attention, output projection and window
    reverse on the LayerNorm'd padded map, no residual.  ``save_attn`` also
    returns the pre-projection attention output.  Not differentiable by
    itself: ``block_attention_train`` is.  CPU tensors run the plain version;
    CUDA tensors launch the kernels or raise."""
    out, ao, _ = _block_attention(x, qkv_w, qkv_b, proj_w, proj_b, table,
                                  num_heads=num_heads, window=window, shift=shift)
    return (out, ao) if save_attn else out


def window_attention_bwd_plain(qkv, d_ao, table, *, batch: int, hp: int, wp: int,
                               num_heads: int, window: int, shift: int = 0):
    """Plain version of K5: from qkv [B*nW*N, 3C] (q pre-scaled by s = d^-1/2)
    and the gradient of the attention output, (dqkv [B*nW*N, 3C] in qkv's
    dtype, the gradients of the qkv projection's output, so dq carries the q
    scale; dtable f32 [(2w-1)^2, heads]).

    The TPU body's formulas and rounding points (``_bwd_kernel``): P
    recomputed in f32; dV = P^T dO with P rounded to the storage type; dP =
    dO V^T; dS = P (dP - rowsum(dP P)); dS s rounded to the storage type, then
    dQ = (dS s) K and dK = (dS s)^T Q / s (Q holds q s); the bias gradient is
    the f32 dS summed over images and windows, scattered into the table's
    rows.  Products accumulate in f32; each output is rounded once."""
    c = qkv.shape[-1] // 3
    n = window * window
    dt = qkv.dtype
    scale = (c // num_heads) ** -0.5
    q, k, v = (_heads(qkv[:, i * c:(i + 1) * c], n, num_heads) for i in range(3))
    do = _heads(d_ao, n, num_heads)
    p = torch.softmax(_scores(q, k, table, batch=batch, hp=hp, wp=wp, window=window,
                              shift=shift), dim=-1)
    dv = p.to(dt).float().transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_s = (ds * scale).to(dt).float()
    dq = ds_s @ k
    dk = ds_s.transpose(-1, -2) @ q / scale

    def rows(t):
        return t.transpose(1, 2).reshape(-1, c)

    dqkv = torch.cat([rows(dq), rows(dk), rows(dv)], 1).to(dt)
    return dqkv, _table_grad(ds.sum(0), window)


@functools.lru_cache(maxsize=None)
def _table_gather(window: int, device: torch.device) -> torch.Tensor:
    return relative_position_gather(window, device)


def _table_grad(dbias: torch.Tensor, window: int) -> torch.Tensor:
    """The bias gradient [heads, N, N] (f32, summed over windows) scattered
    into the table's rows, [(2w-1)^2, heads]: each row's sum in a fixed order
    (``relative_position_gather``), so the result is the same bit for bit
    from call to call."""
    h = dbias.shape[0]
    flat = torch.cat([dbias.reshape(h, -1), dbias.new_zeros(h, 1)], 1)
    return flat[:, _table_gather(window, dbias.device)].sum(-1).t().contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_batch_chunks(batch: int, blocks_per_image: int, sms: int) -> int:
    """Into how many chunks the backward kernels (K5, K8's backward; bf16
    and fp32 alike, one block an SM) split the batch: one block per (window, head, chunk), each walking its
    chunk's images in order.  Enough chunks for about ``_BWD_WAVES`` waves of
    blocks over ``sms`` SMs, one where the windows and heads alone fill them,
    at most one per image.  Each chunk adds a [nW, heads, N, N] f32 slice to
    the partial bias gradient."""
    return max(1, min(batch, -(-_BWD_WAVES * sms // blocks_per_image)))


def _bwd_chunks(t: torch.Tensor, batch: int, blocks_per_image: int) -> int:
    """``bwd_batch_chunks`` on ``t``'s card."""
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return bwd_batch_chunks(batch, blocks_per_image, _sm_count(index))


def window_attention_bwd(qkv, d_ao, table, *, batch: int, hp: int, wp: int, num_heads: int,
                         window: int, shift: int = 0):
    """K5: window-attention backward with the probabilities recomputed (see
    ``window_attention_bwd_plain``).  One kernel launch (bf16:
    ``csrc/win_attn_bwd_mma.cu``; fp32: ``csrc/win_attn_f32.cu``; the batch
    split into ``bwd_batch_chunks`` chunks) sums the bias
    gradient over each chunk's images per window of the image, [chunks, nW,
    heads, N, N rounded up to a multiple of 4] f32; the sum over chunks and
    windows and the scatter of the real N columns into the table's rows are
    plain torch in a fixed order, as the table gather is outside the TPU
    kernel too.  Windows up to 12, odd or even.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, d_ao, table, batch=batch, hp=hp, wp=wp,
                                          num_heads=num_heads, window=window, shift=shift)
    rows, c3 = qkv.shape
    c = c3 // 3
    n = window * window
    nw = (hp // window) * (wp // window)
    dt = qkv.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"window_attention_bwd: unsupported dtype {dt}")
    if c != 32 * num_heads:
        raise ValueError(f"window_attention_bwd: head dim must be 32, got {c}/{num_heads}")
    if window > _MAX_BWD_WINDOW:
        raise ValueError(f"window_attention_bwd: window {window} exceeds {_MAX_BWD_WINDOW} "
                         f"(the block's shared memory)")
    if hp % window or wp % window or rows != batch * nw * n:
        raise ValueError(f"window_attention_bwd: {rows} rows for {batch} maps of {hp}x{wp}")
    _cuda.require(qkv, "qkv", dt, (rows, 3 * c))
    _cuda.require(d_ao, "d_ao", dt, (rows, c))
    _cuda.require(table, "table", torch.float32, ((2 * window - 1) ** 2, num_heads))
    lib = _cuda.library()
    chunks = _bwd_chunks(qkv, batch, nw * num_heads)
    dqkv = torch.empty_like(qkv)
    # bias-gradient rows padded to whole fours of columns (an odd window's N)
    dbias = torch.empty((chunks, nw, num_heads, n, -(-n // 4) * 4), dtype=torch.float32,
                        device=qkv.device)
    _cuda.check(lib.grit_window_attn_bwd(
        qkv.data_ptr(), d_ao.data_ptr(), table.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
        batch, chunks, c, num_heads, (c // num_heads) ** -0.5, hp, wp, window, shift,
        _cuda.DTYPE_CODE[dt], _cuda.stream()), "window_attention_bwd")
    LAUNCHES["window_attention_bwd"] += 1
    LAUNCHES["win_attn_bwd_" + _dtype_name(dt)] += 1
    return dqkv, _table_grad(dbias.sum((0, 1))[..., :n], window)


class _BlockAttentionFn(torch.autograd.Function):
    """K4 forward; backward = plain matrix products for the two projections
    around K5 (the TPU's ``_block_attention_bwd``), except that the forward's
    qkv is kept instead of recomputed."""

    @staticmethod
    def forward(ctx, x, qkv_w, qkv_b, proj_w, proj_b, table, num_heads, window, shift):
        out, ao, qkv = _block_attention(x, qkv_w, qkv_b, proj_w, proj_b, table,
                                        num_heads=num_heads, window=window, shift=shift)
        ctx.save_for_backward(x, qkv_w, proj_w, table, ao, qkv)
        ctx.geo = (num_heads, window, shift)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, qkv_w, proj_w, table, ao, qkv = ctx.saved_tensors
        num_heads, window, shift = ctx.geo
        b, hp, wp, c = x.shape
        dt = x.dtype
        dout_w = _to_windows(dout.to(dt), window, shift).contiguous()
        d_proj_w = dout_w.t() @ ao
        d_proj_b = dout_w.float().sum(0).to(dt)
        d_ao = dout_w @ proj_w
        dqkv, dtable = window_attention_bwd(qkv, d_ao, table, batch=b, hp=hp, wp=wp,
                                            num_heads=num_heads, window=window, shift=shift)
        d_qkv_w = dqkv.t() @ _to_windows(x, window, shift)
        d_qkv_b = dqkv.float().sum(0).to(dt)
        dx = _from_windows(dqkv @ qkv_w, window, shift, hp, wp)
        return dx, d_qkv_w, d_qkv_b, d_proj_w, d_proj_b, dtable, None, None, None


def block_attention_train(x, qkv_w, qkv_b, proj_w, proj_b, table, *, num_heads: int,
                          window: int, shift: int = 0) -> torch.Tensor:
    """Differentiable K4 (backward through K5): the attention branch of a
    training block on the LayerNorm'd padded map, gradients to all six
    tensors."""
    return _BlockAttentionFn.apply(x, qkv_w, qkv_b, proj_w, proj_b, table, num_heads,
                                   window, shift)


def block_attention_train_plain(x, qkv_w, qkv_b, proj_w, proj_b, table, *, num_heads: int,
                                window: int, shift: int = 0) -> torch.Tensor:
    """``block_attention_train`` through the plain version and autograd."""
    return block_attention_plain(x, qkv_w, qkv_b, proj_w, proj_b, table, num_heads=num_heads,
                                 window=window, shift=shift)[0]


def mlp_plain(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, *, eps: float = LN_EPS,
              residual: bool = True) -> torch.Tensor:
    """Plain version of K2: rows [R, C] -> [x +] fc2(GELU(fc1(LN(x)))).
    ``fc2_b`` None: fc2 without its bias (a tensor-parallel rank's partial
    over its slice of the hidden units, with ``residual=False``)."""
    dt = x.dtype
    xf = x.float()
    xn = _ln_fast(xf, norm_w, norm_b, eps).to(dt).float()
    h = F.linear(xn, fc1_w.float(), fc1_b.float())
    h = (h * 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))).to(dt).float()
    y = F.linear(h, fc2_w.float(), None if fc2_b is None else fc2_b.float())
    return ((xf + y) if residual else y).to(dt)


def _mlp_recompute(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps: float,
                   residual: bool) -> torch.Tensor:
    """The function whose gradient K2's backward (``_mlp_backward``) takes:
    ``mlp_plain`` with the two matrix products taken in the rows' dtype (f32
    accumulation, the pre-activation rounded once more in bf16; identical in
    f32).  Autograd through it is the yardstick of that backward."""
    dt = x.dtype
    xf = x.float()
    xn = _ln_fast(xf, norm_w, norm_b, eps).to(dt)
    h = F.linear(xn, fc1_w, fc1_b).float()
    h = (h * 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))).to(dt)
    y = F.linear(h, fc2_w, fc2_b)
    return (xf + y.float()).to(dt) if residual else y


def _mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps: float, residual: bool):
    if x.device.type == "cpu":
        return mlp_plain(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps=eps,
                         residual=residual)
    c = x.shape[1]
    hid = fc1_w.shape[0]
    dt = x.dtype
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"mlp: unsupported dtype {dt}")
    check_ln_shape(c, dt, "mlp ln2")
    check_gemm_shape(hid, c, dt, "mlp fc1")
    check_gemm_shape(c, hid, dt, "mlp fc2")
    for t, name, t_dt, shape in (
            (x, "x", dt, None), (fc1_w, "fc1_w", dt, (hid, c)), (fc1_b, "fc1_b", dt, (hid,)),
            (fc2_w, "fc2_w", dt, (c, hid)), (fc2_b, "fc2_b", dt, (c,)),
            (norm_w, "norm_w", torch.float32, (c,)), (norm_b, "norm_b", torch.float32, (c,))):
        if t is not None:
            _cuda.require(t, name, t_dt, shape)
    xn = _ln_rows(x, norm_w, norm_b, eps, "mlp ln2")
    h = gemm(xn, fc1_w, fc1_b, epilogue="gelu")
    out = gemm(h, fc2_w, fc2_b, epilogue="resid" if residual else "bias",
               resid=x if residual else None)
    LAUNCHES["mlp"] += 1
    return out


def gelu_bwd_plain(u, dg):
    """Plain version of K2's GELU backward over the hidden rows: from the
    pre-activation u [R, H] and dg, the gradient of the GELU's output, (g =
    gelu(u), du = dg gelu'(u), fc1's bias gradient), with gelu'(u) = (1 +
    erf(u / sqrt 2)) / 2 + u exp(-u^2 / 2) / sqrt(2 pi) in f32, g and du each
    rounded once to u's dtype, and the bias gradient the f32 column sums of
    du as rounded, rounded to u's dtype."""
    dt = u.dtype
    uf = u.float()
    e = torch.erf(uf * 0.7071067811865476)
    g = (uf * 0.5 * (1.0 + e)).to(dt)
    du = (dg.float() * (0.5 * (1.0 + e) + uf * 0.3989422804014327
                        * torch.exp(-0.5 * uf * uf))).to(dt)
    return g, du, du.float().sum(0).to(dt)


def gelu_bwd(u, dg):
    """K2's GELU backward (see ``gelu_bwd_plain``) -> (g, du, fc1's bias
    gradient).  On the card one pass (``gelu_bwd_kernel``) writes g over u
    and du over dg, so both are consumed, and a second sums its blocks'
    column partials in a fixed order.  CPU tensors run the plain version;
    CUDA tensors launch the kernels or raise."""
    if u.device.type == "cpu":
        return gelu_bwd_plain(u, dg)
    rows, hid = u.shape
    dt = u.dtype
    if dt not in LN_CHUNK or hid % LN_CHUNK[dt]:
        raise ValueError(f"gelu_bwd: rows of {hid} {dt} values are not whole 16-byte chunks")
    _cuda.require(u, "u", dt)
    _cuda.require(dg, "dg", dt, (rows, hid))
    lib = _cuda.library()
    part = torch.empty((lib.grit_gelu_bwd_blocks(rows), hid), dtype=torch.float32,
                       device=u.device)
    db = torch.empty(hid, dtype=dt, device=u.device)
    _cuda.check(lib.grit_gelu_bwd(u.data_ptr(), dg.data_ptr(), part.data_ptr(), db.data_ptr(),
                                  rows, hid, _cuda.DTYPE_CODE[dt], _cuda.stream()), "gelu_bwd")
    LAUNCHES["gelu_bwd_" + _dtype_name(dt)] += 1
    return u, dg, db


def ln_rows_bwd_plain(x, norm_w, d_xn, dy=None, *, eps: float = LN_EPS):
    """Plain version of K2's LayerNorm backward over rows x [R, C]: from
    d_xn, the gradient of the normalised rows, (dx, the scale's gradient, the
    bias's gradient).  The row's statistics are recomputed as the forward's
    (f32, var = E[x^2] - mu^2); dx = rsqrt(var + eps) (d_xn w - mean(d_xn w)
    - xhat mean(d_xn w xhat)) (+ ``dy``, the residual's gradient) in f32,
    rounded once to x's dtype; the parameter gradients are f32 column sums."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    rs = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mu * mu + eps)
    xh = (xf - mu) * rs
    gf = d_xn.float()
    gw = gf * norm_w.float()
    dx = rs * (gw - gw.mean(-1, keepdim=True) - xh * (gw * xh).mean(-1, keepdim=True))
    if dy is not None:
        dx = dx + dy.float()
    return dx.to(x.dtype), (gf * xh).sum(0), gf.sum(0)


def ln_rows_bwd(x, norm_w, d_xn, dy=None, *, eps: float = LN_EPS):
    """K2's LayerNorm backward (see ``ln_rows_bwd_plain``).  On the card one
    pass (``ln_rows_bwd_kernel``, a row in registers) and a second that sums
    its blocks' column partials in a fixed order.  CPU tensors run the plain
    version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return ln_rows_bwd_plain(x, norm_w, d_xn, dy, eps=eps)
    rows, c = x.shape
    dt = x.dtype
    check_ln_shape(c, dt, "ln_rows_bwd")
    _cuda.require(x, "x", dt)
    _cuda.require(d_xn, "d_xn", dt, (rows, c))
    if dy is not None:
        _cuda.require(dy, "dy", dt, (rows, c))
    _cuda.require(norm_w, "norm_w", torch.float32, (c,))
    lib = _cuda.library()
    code = _cuda.DTYPE_CODE[dt]
    part = torch.empty((lib.grit_ln_rows_bwd_blocks(rows, c, code), 2 * c),
                       dtype=torch.float32, device=x.device)
    dwb = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    _cuda.check(lib.grit_ln_rows_bwd(
        x.data_ptr(), norm_w.data_ptr(), d_xn.data_ptr(), None if dy is None else dy.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dwb.data_ptr(), rows, c, eps, code, _cuda.stream()),
        "ln_rows_bwd")
    LAUNCHES["ln_rows_bwd_" + _dtype_name(dt)] += 1
    return dx, dwb[:c], dwb[c:]


def _mlp_backward(dy, x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps: float,
                  residual: bool):
    """K2's backward: the gradients of ``_mlp_recompute`` to its seven inputs
    (None for an absent ``fc2_b``).  The LayerNorm is the forward's own
    launch, so the products see the forward's bits; fc1's pre-activation is
    recomputed; the five products run on torch's matmul in the rows' dtype
    (f32 accumulation), around ``gelu_bwd`` and ``ln_rows_bwd``.  The bias
    gradients are f32 sums rounded to the biases' dtype.  CPU tensors take
    the plain versions of every step."""
    dy = dy.to(x.dtype).contiguous()
    xn = _ln_rows(x, norm_w, norm_b, eps, "mlp backward ln2")
    g, du, d_fc1_b = gelu_bwd(F.linear(xn, fc1_w, fc1_b), dy @ fc2_w)
    d_fc2_w = dy.t() @ g
    del g
    d_fc1_w = du.t() @ xn
    dx, d_norm_w, d_norm_b = ln_rows_bwd(x, norm_w, du @ fc1_w,
                                         dy if residual else None, eps=eps)
    if x.device.type != "cpu":
        LAUNCHES["mlp_bwd"] += 1
    return (dx, d_norm_w, d_norm_b, d_fc1_w, d_fc1_b, d_fc2_w,
            None if fc2_b is None else dy.sum(0))


class _MlpFn(torch.autograd.Function):
    """K2 forward; backward recomputes the branch from the row input (the
    TPU's ``_mlp_bwd``) through ``_mlp_backward``: nothing is kept but the
    inputs."""

    @staticmethod
    def forward(ctx, x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps, residual):
        ctx.save_for_backward(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b)
        ctx.cfg = (eps, residual)
        return _mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps, residual)

    @staticmethod
    def backward(ctx, dy):
        return (*_mlp_backward(dy, *ctx.saved_tensors, *ctx.cfg), None, None)


def mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, *, eps: float = LN_EPS,
        residual: bool = True) -> torch.Tensor:
    """K2: the Swin MLP half-block on rows [R, C] (see ``mlp_plain``), with
    its residual or, for a caller that applies drop-path first, the branch
    alone; with ``fc2_b`` None and ``residual=False``, a tensor-parallel
    rank's partial (fc1 and fc2 on its slice of the hidden units, fc2's
    ``bias`` epilogue without a bias: the partial in the rows' dtype).
    Differentiable.  CPU tensors run the plain version; CUDA tensors launch
    the kernels or raise."""
    return _MlpFn.apply(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps, residual)


# ---------------------------------------------------------------------------
# K8: the window-attention core on separate q, k, v and a dense additive bias
# ---------------------------------------------------------------------------

def window_attention_plain(q, k, v, bias, scale: float, num_heads: int) -> torch.Tensor:
    """Plain version of K8: softmax(q k^T * scale + bias) v per (window, head).

    q, k, v: [B, nW, N, C] with the heads merged in C; bias: [M, heads, N, N]
    with M == nW or 1 (f32 in the kernel).  q is scaled and rounded to the
    storage type before the product, the probabilities are rounded to it
    before the value product, sums are f32."""
    b, nw, n, c = q.shape
    d = c // num_heads
    dt = q.dtype

    def heads(t):
        return t.float().reshape(b, nw, n, num_heads, d).permute(0, 1, 3, 2, 4)

    s = heads((q.float() * scale).to(dt)) @ heads(k).transpose(-1, -2) + bias.float()[None]
    p = torch.softmax(s, dim=-1).to(dt).float()
    return (p @ heads(v)).permute(0, 1, 3, 2, 4).reshape(b, nw, n, c).to(dt)


def _dense_attention_check(q, k, v, bias, num_heads: int) -> int:
    """Validate K8's arguments on the card; returns the window side."""
    b, nw, n, c = q.shape
    dt = q.dtype
    win = int(round(n ** 0.5))
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"window_attention: unsupported dtype {dt}")
    if c != 32 * num_heads:
        raise ValueError(f"window_attention: head dim must be 32, got {c}/{num_heads}")
    if win * win != n or win > _MAX_BWD_WINDOW or n % 4:
        raise ValueError(f"window_attention: {n} tokens a window: need an even square <= "
                         f"{_MAX_BWD_WINDOW ** 2} (the block's shared memory)")
    if bias.shape[0] not in (1, nw):
        raise ValueError(f"window_attention: bias over {bias.shape[0]} windows for {nw}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _cuda.require(t, name, dt, (b, nw, n, c))
    _cuda.require(bias, "bias", torch.float32, (bias.shape[0], num_heads, n, n))
    return win


class _WindowAttentionFn(torch.autograd.Function):
    """K8 forward and backward (dq, dk, dv and the bias gradient in the bias's
    own shape: summed over the batch, and over windows for a one-window bias)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, num_heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.cfg = (scale, num_heads)
        if q.device.type == "cpu":
            return window_attention_plain(q, k, v, bias, scale, num_heads)
        b, nw, n, c = q.shape
        bias_f = bias.float().contiguous()
        win = _dense_attention_check(q, k, v, bias_f, num_heads)
        out = torch.empty_like(q)
        _cuda.check(_cuda.library().grit_window_attn_dense(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_f.data_ptr(), out.data_ptr(),
            b, nw, win, c, num_heads, bias.shape[0], scale, _cuda.DTYPE_CODE[q.dtype],
            _cuda.stream()), "window_attention")
        LAUNCHES["window_attention"] += 1
        LAUNCHES["win_attn_" + _dtype_name(q.dtype)] += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        scale, num_heads = ctx.cfg
        if q.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
                out = window_attention_plain(*leaves, scale, num_heads)
                grads = torch.autograd.grad(out, leaves, dout.to(out.dtype))
            return (*grads, None, None)
        b, nw, n, c = q.shape
        bias_f = bias.float().contiguous()
        win = _dense_attention_check(q, k, v, bias_f, num_heads)
        dout = dout.to(q.dtype).contiguous()
        _cuda.require(dout, "dout", q.dtype, (b, nw, n, c))
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        chunks = _bwd_chunks(q, b, nw * num_heads)
        dbias = torch.empty((chunks, nw, num_heads, n, n), dtype=torch.float32, device=q.device)
        _cuda.check(_cuda.library().grit_window_attn_dense_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), bias_f.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), b, chunks, nw, win, c,
            num_heads, bias.shape[0], scale, _cuda.DTYPE_CODE[q.dtype], _cuda.stream()),
            "window_attention backward")
        LAUNCHES["window_attention_grad"] += 1
        LAUNCHES["win_attn_bwd_" + _dtype_name(q.dtype)] += 1
        dbias = dbias.sum(0)
        if bias.shape[0] == 1:
            dbias = dbias.sum(0, keepdim=True)
        return dq, dk, dv, dbias.to(bias.dtype), None, None


def window_attention(q, k, v, bias, scale: float, num_heads: int) -> torch.Tensor:
    """K8: the window-attention core on given q, k, v and a dense additive
    bias (see ``window_attention_plain``), differentiable in all four, with
    the signature of the JAX package's ``fused_window_attention``.  It runs
    the attention kernels of K1/K4 and K5 in their dense-bias mode.  No model
    path of either package calls it (the Swin blocks go through K1 and K4,
    which read the bias table and the shift regions themselves).  CPU tensors
    run the plain version; CUDA tensors launch the kernels or raise."""
    return _WindowAttentionFn.apply(q, k, v, bias, float(scale), num_heads)


# ---------------------------------------------------------------------------
# K10a / K10b: LayerNorm (+ Linear) over rows
# ---------------------------------------------------------------------------

def _merge_rows(x: torch.Tensor) -> torch.Tensor:
    """PatchMerging's gather: map [B, H, W, C] -> [B, ceil(H/2), ceil(W/2), 4C],
    zero beyond an odd edge."""
    h, w = x.shape[1:3]
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    return torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                     dim=-1)


def ln_linear_plain(x, norm_w, norm_b, w, *, eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of K10a: Linear(LN(x)) over the last axis, no bias; f32
    statistics with var = E[x^2] - mu^2, the normalised rows rounded to the
    storage type, f32 accumulation, one rounding of the output.  ``w``:
    [out, in] (torch Linear layout)."""
    dt = x.dtype
    xn = _ln_fast(x.float(), norm_w, norm_b, eps).to(dt)
    return F.linear(xn.float(), w.float()).to(dt)


def patch_merge_plain(x, norm_w, norm_b, w, *, eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of K10a on the stage map: the 2x2 gather, then
    ``ln_linear_plain``."""
    return ln_linear_plain(_merge_rows(x), norm_w, norm_b, w, eps=eps)


def _ln_linear_recompute(x, norm_w, norm_b, w, eps: float, merge: bool) -> torch.Tensor:
    """What K10a's backward differentiates: the plain version with the product
    taken in the rows' dtype (f32 accumulation; identical in f32)."""
    if merge:
        x = _merge_rows(x)
    return F.linear(_ln_fast(x.float(), norm_w, norm_b, eps).to(x.dtype), w)


def _ln_linear(x, norm_w, norm_b, w, eps: float, merge: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        fn = patch_merge_plain if merge else ln_linear_plain
        return fn(x, norm_w, norm_b, w, eps=eps)
    dt = x.dtype
    n_out, k_in = w.shape
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"ln_linear: unsupported dtype {dt}")
    check_gemm_shape(n_out, k_in, dt, "ln_linear")
    if merge:
        b, h, wd, c = x.shape
        if 4 * c != k_in:
            raise ValueError(f"patch_merge: map of {c} channels for a weight over {k_in}")
        lead, hw = (b, (h + 1) // 2, (wd + 1) // 2), (h, wd)
        check_ln_shape(c, dt, "patch_merge")
    else:
        if x.shape[-1] != k_in:
            raise ValueError(f"ln_linear: rows of {x.shape[-1]} channels for a weight over {k_in}")
        lead, hw = tuple(x.shape[:-1]), (1, 1)
        check_ln_shape(k_in, dt, "ln_linear")
    rows = 1
    for s in lead:
        rows *= s
    _cuda.require(x, "x", dt)
    _cuda.require(w, "w", dt, (n_out, k_in))
    _cuda.require(norm_w, "norm_w", torch.float32, (k_in,))
    _cuda.require(norm_b, "norm_b", torch.float32, (k_in,))
    xn = torch.empty((rows, k_in), dtype=dt, device=x.device)
    out = torch.empty((*lead, n_out), dtype=dt, device=x.device)
    _cuda.check(_cuda.library().grit_ln_linear(
        x.data_ptr(), norm_w.data_ptr(), norm_b.data_ptr(), w.data_ptr(), xn.data_ptr(),
        out.data_ptr(), rows, n_out, k_in, int(merge), *hw, eps, _cuda.DTYPE_CODE[dt],
        _cuda.stream()), "ln_linear")
    LAUNCHES["ln_linear"] += 1
    LAUNCHES["gemm_" + _dtype_name(dt)] += 1   # the product inside grit_ln_linear
    return out


class _RecomputeFn(torch.autograd.Function):
    """A kernel forward whose backward recomputes through a plain function of
    the same tensor inputs and differentiates that (the TPU's ``_lnlin_bwd``
    and ``_ln_bwd``): nothing is kept but the inputs."""

    @staticmethod
    def forward(ctx, kernel, recompute, cfg, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.recompute, ctx.cfg = recompute, cfg
        return kernel(*tensors, *cfg)

    @staticmethod
    def backward(ctx, dy):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = ctx.recompute(*leaves, *ctx.cfg)
            grads = torch.autograd.grad(y, leaves, dy.to(y.dtype))
        return (None, None, None, *grads)


def ln_linear(x, norm_w, norm_b, w, *, eps: float = LN_EPS) -> torch.Tensor:
    """K10a on rows: Linear(LN(x)) over the last axis of x [..., in] with
    ``w`` [out, in], no bias (see ``ln_linear_plain``).  Differentiable (the
    backward recomputes).  CPU tensors run the plain version; CUDA tensors
    launch the kernels or raise."""
    return _RecomputeFn.apply(_ln_linear, _ln_linear_recompute, (eps, False),
                              x, norm_w, norm_b, w)


def patch_merge(x, norm_w, norm_b, w, *, eps: float = LN_EPS) -> torch.Tensor:
    """K10a on the stage map [B, H, W, C] -> [B, ceil(H/2), ceil(W/2), out]:
    PatchMerging's 2x2 gather and odd-edge zero pad folded into the LayerNorm's
    load address, then the reduction (see ``patch_merge_plain``).
    Differentiable.  CPU tensors run the plain version; CUDA tensors launch the
    kernels or raise."""
    return _RecomputeFn.apply(_ln_linear, _ln_linear_recompute, (eps, True),
                              x, norm_w, norm_b, w)


def layernorm_rows_plain(x, norm_w, norm_b, eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of K10b: LayerNorm over the last axis, f32 statistics
    with var = E[x^2] - mu^2, the result in x's dtype."""
    return _ln_fast(x.float(), norm_w, norm_b, eps).to(x.dtype)


def _ln_rows(x, norm_w, norm_b, eps: float, what: str) -> torch.Tensor:
    """One row-mode launch of ``ln_rows_kernel`` over the last axis of x
    (``layernorm_rows_plain`` on the CPU), counted by its caller."""
    if x.device.type == "cpu":
        return layernorm_rows_plain(x, norm_w, norm_b, eps=eps)
    dt = x.dtype
    c = x.shape[-1]
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"{what}: unsupported dtype {dt}")
    check_ln_shape(c, dt, what)
    _cuda.require(x, "x", dt)
    _cuda.require(norm_w, "norm_w", torch.float32, (c,))
    _cuda.require(norm_b, "norm_b", torch.float32, (c,))
    out = torch.empty_like(x)
    _cuda.check(_cuda.library().grit_ln_rows(
        x.data_ptr(), norm_w.data_ptr(), norm_b.data_ptr(), out.data_ptr(), x.numel() // c, c,
        0, 1, 1, 1, 0, 1, 1, eps, _cuda.DTYPE_CODE[dt], _cuda.stream()), what)
    return out


def _layernorm_rows(x, norm_w, norm_b, eps: float) -> torch.Tensor:
    out = _ln_rows(x, norm_w, norm_b, eps, "layernorm_rows")
    if x.is_cuda:
        LAUNCHES["layernorm_rows"] += 1
    return out


def layernorm_rows(x, norm_w, norm_b, *, eps: float = LN_EPS) -> torch.Tensor:
    """K10b: LayerNorm over the last axis of x [..., C] in one pass (see
    ``layernorm_rows_plain``).  Differentiable (the backward recomputes).  CPU
    tensors run the plain version; CUDA tensors launch the kernel or raise."""
    return _RecomputeFn.apply(_layernorm_rows, layernorm_rows_plain, (eps,),
                              x, norm_w, norm_b)
