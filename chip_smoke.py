"""GPU smoke test of the PyTorch/CUDA port (grit_tpu_torch) on one card.

  python3 chip_smoke.py              # every phase
  python3 chip_smoke.py --profile    # and torch.profiler passes over one caption
                                     # batch and one training step
  python3 chip_smoke.py --parity-seeds 3   # and phase 7's gradient errors at 3
                                     # further batch seeds, reported only

Phases, each of which must pass:
  1. build the Hopper kernels from grit_tpu_torch/csrc (nvcc, sm_90a);
  2. every kernel against its plain PyTorch version on the card, in fp32 and
     bf16, with CUDA-event timings, at every shape each main path gives it.
     Caption inference at 384x640, b8: K1 (Swin attention half-block), K2
     (Swin MLP) and K3 (MSDA).  One b16 training step: K1 and K2 on the
     frozen stage 1; K4 (training attention branch, both outputs), K5
     (window-attention backward: dq, dk, dv, dtable) and K2 with
     residual=False on the unpadded rows, at the three stages that train; K3
     and K6 (MSDA backward: dvalue, dloc, dattn) at the caption pyramid.  K3
     and K6 also at the 832x1344 detection pyramid (S = 23205), where the
     TPU needed S-chunked variants;
  3. library yardsticks, timed and used nowhere in the port: F.linear at the
     four GEMM shapes of a Swin block and scaled_dot_product_attention with
     an additive mask at the attention core's shape, per stage;
  4. the inference path: batch caption inference at the full width of the
     shipped GRIT model on random weights (seed 0), bf16, beam 5, 20 steps,
     through grit_tpu_torch.engine.evaluator.make_caption_generator, with
     each kernel's launch count checked against one forward's calls;
  5. the same model in fp32, kernel path against plain path: features within
     tolerance, captions token for token (a difference only at a near-tie:
     at the first differing step, the gap between adjacent candidates among
     the top beam+1 must be <= 1e-3); then the bf16 kernel path's features
     against the fp32 plain path's;
  6. the training path: XE caption training steps at full width, b16,
     384x640 uint8 images (half of them padded), 20-token captions with pad
     tails, frozen_stages=2, the config's dropouts and drop-path on, bf16
     compute with f32 master parameters, through
     grit_tpu_torch.engine.xe.make_xe_train_step: a warm-up step, one step
     whose kernel launch counts are checked, then timed steps with the loss
     printed and finite each step, and the validation loss in eval() below
     the first step's;
  7. training parity in fp32 with dropout and drop-path at 0, at the training
     step's b16: one step through the kernel path, one through the plain
     path and one through the plain path in float64, from the same weights
     and batch; the kernel path's loss, every gradient leaf and every updated
     parameter held against the float64 step's, by module group, beside the
     plain fp32 path's distance from it; then each Swin block that trains
     (K4, K5, K2) and each deformable cross-attention (K3, K6) alone, kernels
     against plain on the same inputs and output gradient, where the bound
     is tight.

Prints the card's name and power limit as nvidia-smi reports them, a JSON
line of per-kernel results, and last {"ok": true, "device": {...}}; the
per-shape results go to chiprun_out/chip_smoke.json.  Exits non-zero, without
that last line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


try:
    import numpy as np
    import torch

    from grit_tpu_torch.config import default_caption_config
    from grit_tpu_torch.decoding.beam_search import beam_search
    from grit_tpu_torch.engine import optim as optim_lib
    from grit_tpu_torch.engine import xe as xe_lib
    from grit_tpu_torch.engine.evaluator import make_caption_generator
    from grit_tpu_torch.models.captioner import build_captioner, to_compute_dtype
    from grit_tpu_torch.models.layers import Dropout
    from grit_tpu_torch.models.swin import SwinBlock
    from grit_tpu_torch.ops import _cuda
    from grit_tpu_torch.ops import msda as msda_ops
    from grit_tpu_torch.ops import window_attention as wa
    from grit_tpu_torch.utils.nested import ImageBatch
except ImportError as exc:  # e.g. run outside a checkout of the repo
    print(f"chip_smoke: FAIL: cannot import the port: {exc}", file=sys.stderr)
    sys.exit(2)

DEV = "cuda"
HW = (384, 640)
WINDOW = 12
# Swin-B stage maps at 384x640 (H/4 ... H/32), padded to window multiples
STAGES = [  # (name, C, heads, real (h, w), padded (Hp, Wp), depth)
    ("stage1", 128, 4, (96, 160), (96, 168), 2),
    ("stage2", 256, 8, (48, 80), (48, 84), 2),
    ("stage3", 512, 16, (24, 40), (24, 48), 18),
    ("stage4", 1024, 32, (12, 20), (12, 24), 2),
]
MSDA_LEVELS = ((48, 80), (24, 40), (12, 20), (6, 10))
# the detector pre-training pyramid at 832x1344, where the TPU needed its
# S-chunked MSDA kernels (K7a, K7b); served here by K3 and K6 themselves
DET_LEVELS = ((104, 168), (52, 84), (26, 42), (13, 21))
DET_LAYERS = 6
TRAIN_BATCH, CAPTION_LEN, FROZEN_STAGES, TRAIN_STEPS = 16, 20, 2, 6
# published dense peaks of one H100 SXM (NVIDIA's data sheet): bf16 tensor
# cores, f32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
BEAM, STEPS = 5, 20
NEAR_TIE = 1e-3
TIMED_REPS = 7
# max |kernel - plain| / max |plain| per kernel call: fp32 differs by
# summation order only; bf16 by a few storage-type ulps (2^-7 relative) where
# the two f32 sums round to neighbouring bf16 values
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# the same at fp32 end to end: gri_feat (24 Swin blocks), and each decoder
# layer given the same inputs in both paths.  Run freely, the random-weight
# decoder multiplies a difference by 2-4.5 at each of its 6 layers (its
# states feed its boxes, its boxes its sampling locations), so reg_feat
# grows from the first layer's ~1e-6 to ~2e-4 and gets REG_FEAT_TOL
FEATURE_TOL, REG_FEAT_TOL = 1e-4, 1e-3
# bf16 kernel path against the fp32 plain path, relative RMS error: bf16
# rounds at 2^-9 relative, and 24 Swin blocks and the grid net compound it
# (gri_feat; the detector's first layer likewise).  The same growth through
# the decoder gives reg_feat a bound that only a broken path (uncorrelated
# features read ~1.4) exceeds
BF16_RMS_TOL, BF16_REG_RMS_TOL = 5e-2, 0.5

# fp32 training parity (one step from the same weights and batch, dropouts
# off), with the plain path in float64 as the yardstick.  The loss is a mean
# over ~300 tokens of f32 log-probs.  A gradient is no continuous function of
# the forward pass: a ReLU gate or the floor() of a sampling location that
# flips under a rounding-size difference moves a whole token's contribution,
# and every leaf upstream of it.  Each fp32 path draws its own flips against
# float64: over four batches the kernel path's worst leaf of a module group
# read 0.01 to 73 times the plain path's, and either path's up to 5.6e-2 of
# the leaf's max (PERF.md).  So end to end a gradient leaf is held only to
# FLIP_TOL, which a wrong gradient (it reads ~1) exceeds and a flip does not;
# the tight bound, SAME_INPUT_TOL, is on what cannot flip: each kernel alone
# (TOL), and each module that holds a kernel with a backward alone on the
# model's own activations.  Errors are shares of max(the leaf's max,
# GRAD_FLOOR): a gradient that is zero in exact arithmetic (an attention key
# bias: softmax ignores a shift of its scores) is f32 noise
LOSS_TOL = 1e-5
FLIP_TOL, GRAD_FLOOR, SAME_INPUT_TOL = 0.25, 1e-6, 2e-5
# the kernel path's update against Adam's first step on its own gradient,
# -lr g / (|g| + 1e-8), as a share of the group's learning rate
UPDATE_TOL = 1e-3

BATCH_SEED = 0   # of the synthetic images and captions

RESULTS: dict[str, dict] = {}
DETAIL: list[dict] = []
YARDSTICKS: dict[str, float] = {}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare(kernel: str, case: str, out, ref, dtype, ms: float, plain_ms: float,
            calls: int, work: tuple[float, float] | None = None, run: str = "caption") -> None:
    """Hold one kernel output against the plain version's.  ``calls``: how
    often one ``run`` of a main path ("caption": a b8 caption forward,
    "train": a b16 XE training step) makes this call (0: a check only);
    ``work``: (bytes moved once each, operations) of the call, for the bound."""
    if not torch.isfinite(out).all():
        fail(f"{kernel} {case}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    tol = TOL[dtype]
    print(f"  {kernel} {case:<30} max_abs {err:.3e} max_rel {rel:.3e} (tol {tol:.0e})  "
          f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)
    if rel > tol:
        fail(f"{kernel} {case}: max rel err {rel:.3e} > {tol:.0e}")
    rec = RESULTS.setdefault(kernel, {"max_abs_err": 0.0, **{
        r: {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
        for r in ("caption", "train")}})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    row = {"kernel": kernel, "case": case, "max_abs_err": err, "max_rel_err": rel,
           "tol": tol, "ms": ms, "plain_ms": plain_ms, "calls_per_run": calls, "run": run}
    if work is not None:
        row["bytes_ms"] = work[0] / PEAK_BYTES * 1e3
        row["ops_ms"] = work[1] / PEAK_FLOPS[dtype] * 1e3
    DETAIL.append(row)
    if dtype == torch.bfloat16 and calls and work is not None:
        # the main path's time in this kernel per run: each shape's median
        # time, and its least possible time, times the calls one run makes at
        # that shape
        acc = rec[run]
        acc["ms"] += ms * calls
        acc["plain_ms"] += plain_ms * calls
        acc["bytes_ms"] += row["bytes_ms"] * calls
        acc["ops_ms"] += row["ops_ms"] * calls


def esize(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def block_work(rows: int, c: int, heads: int, dtype, maps: int) -> tuple[float, float]:
    """K1 / K4: ``maps`` row-by-C tensors in and out, the four projection
    matrices once; the qkv and proj products and the two attention products."""
    n = WINDOW * WINDOW
    return ((maps * rows * c + 4 * c * c + 4 * c) * esize(dtype) + (2 * WINDOW - 1) ** 2 * heads * 4,
            8.0 * rows * c * c + 4.0 * rows * n * c)


def mlp_work(rows: int, c: int, dtype) -> tuple[float, float]:
    return (2 * rows * c + 8 * c * c + 5 * c) * esize(dtype) + 8 * c, 16.0 * rows * c * c


def msda_work(n: int, s: int, lq: int, mh: int, d: int, taps: int, dtype,
              backward: bool) -> tuple[float, float]:
    """Forward: value, locations, weights in, output out; 4 corners of a
    multiply-add and the weighting per tap and channel.  Backward: also dOut
    in and the three gradients out; about three times the arithmetic."""
    c = mh * d
    meta = n * lq * mh * taps * 3 * 4
    nbytes = (n * s * c + n * lq * c) * esize(dtype) + meta
    ops = 10.0 * n * lq * c * taps
    if backward:
        nbytes += n * s * c * esize(dtype) + meta
        ops *= 3
    return nbytes, ops


def phase_kernels(batch: int) -> None:
    print(f"[kernels] kernel vs plain at the {HW[0]}x{HW[1]} main-path shapes, b{batch}",
          flush=True)
    g = torch.Generator(device=DEV).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        for name, c, heads, real, (hp, wp), depth in STAGES:
            x = torch.zeros(batch, hp, wp, c, device=DEV)
            x[:, :real[0], :real[1]] = rnd(batch, real[0], real[1], c)
            x = x.to(dtype)
            p = dict(norm_w=1 + rnd(c, scale=0.1), norm_b=rnd(c, scale=0.1),
                     qkv_w=rnd(3 * c, c, scale=c ** -0.5).to(dtype),
                     qkv_b=rnd(3 * c, scale=0.02).to(dtype),
                     proj_w=rnd(c, c, scale=c ** -0.5).to(dtype),
                     proj_b=rnd(c, scale=0.02).to(dtype),
                     table=rnd((2 * WINDOW - 1) ** 2, heads))
            for shift in (0, WINDOW // 2):
                kw = dict(num_heads=heads, window=WINDOW, real_hw=real, shift=shift)
                out = wa.block_step(x, **p, **kw)
                ref = wa.block_step_plain(x, **p, **kw)
                # outputs at window-padding tokens are unspecified: compare the real map
                compare("K1", f"{dn} {name} shift={shift}", out[:, :real[0], :real[1]],
                        ref[:, :real[0], :real[1]], dtype,
                        cuda_ms(lambda: wa.block_step(x, **p, **kw)),
                        cuda_ms(lambda: wa.block_step_plain(x, **p, **kw)), depth // 2,
                        block_work(batch * hp * wp, c, heads, dtype, 2))
            rows = x.reshape(-1, c)
            m = [1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
                 rnd(4 * c, c, scale=c ** -0.5).to(dtype), rnd(4 * c, scale=0.02).to(dtype),
                 rnd(c, 4 * c, scale=(4 * c) ** -0.5).to(dtype), rnd(c, scale=0.02).to(dtype)]
            compare("K2", f"{dn} {name}", wa.mlp(rows, *m), wa.mlp_plain(rows, *m), dtype,
                    cuda_ms(lambda: wa.mlp(rows, *m)), cuda_ms(lambda: wa.mlp_plain(rows, *m)),
                    depth, mlp_work(rows.shape[0], c, dtype))
            compare("K2", f"{dn} {name} residual=False", wa.mlp(rows, *m, residual=False),
                    wa.mlp_plain(rows, *m, residual=False), dtype,
                    cuda_ms(lambda: wa.mlp(rows, *m, residual=False)),
                    cuda_ms(lambda: wa.mlp_plain(rows, *m, residual=False)), 0)

        args = msda_inputs(g, batch, MSDA_LEVELS, dtype)
        compare("K3", f"{dn} 384x640 pyramid", msda_ops.msda(*args),
                msda_ops.msda_plain(*args), dtype, cuda_ms(lambda: msda_ops.msda(*args)),
                cuda_ms(lambda: msda_ops.msda_plain(*args)), DET_LAYERS,
                msda_work(batch, args[0].shape[1], 150, 8, 64, 16, dtype, False))


def msda_inputs(g, batch: int, levels, dtype):
    """(value, levels, locations, weights, real_hw) at the detector's widths
    (150 queries, 8 heads of 64 channels, 4 points); locations spill past
    [0, 1] so zero padding is exercised, and half the images are padded."""
    s = sum(h * w for h, w in levels)
    lq, mh, d, L, P = 150, 8, 64, len(levels), 4
    value = (torch.randn(batch, s, mh * d, generator=g, device=DEV)).to(dtype)
    loc = torch.rand(batch, lq, mh, L, P, 2, generator=g, device=DEV) * 1.2 - 0.1
    attn = torch.softmax(torch.randn(batch, lq, mh, L * P, generator=g, device=DEV), -1)
    real_hw = torch.tensor(levels, device=DEV).repeat(batch, 1, 1)
    real_hw[1::2] = (real_hw[1::2] * 3 + 3) // 4
    return value, levels, loc, attn.reshape(batch, lq, mh, L, P), real_hw


def phase_train_kernels(batch: int) -> None:
    """Every kernel at the shapes one b16 training step gives it: K1 and K2
    (with its residual) on the padded map of the frozen stage 1; K4, K5 and K2
    with ``residual=False`` (on the unpadded rows) at the three stages that
    train; K3 and K6 at the caption pyramid, and at the 832x1344 detection
    pyramid."""
    print(f"[kernels] kernels vs plain (autograd for the backwards) at the {HW[0]}x{HW[1]} "
          f"shapes of one training step, b{batch}", flush=True)
    g = torch.Generator(device=DEV).manual_seed(1)
    n = WINDOW * WINDOW

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        for k, (name, c, heads, real, (hp, wp), depth) in enumerate(STAGES):
            frozen = k < FROZEN_STAGES - 1
            rows = batch * hp * wp
            x = torch.zeros(batch, hp, wp, c, device=DEV)     # zero outside the real map
            x[:, :real[0], :real[1]] = rnd(batch, real[0], real[1], c)
            x = x.to(dtype)
            p = dict(qkv_w=rnd(3 * c, c, scale=c ** -0.5).to(dtype),
                     qkv_b=rnd(3 * c, scale=0.02).to(dtype),
                     proj_w=rnd(c, c, scale=c ** -0.5).to(dtype),
                     proj_b=rnd(c, scale=0.02).to(dtype),
                     table=rnd((2 * WINDOW - 1) ** 2, heads))
            m = [1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
                 rnd(4 * c, c, scale=c ** -0.5).to(dtype), rnd(4 * c, scale=0.02).to(dtype),
                 rnd(c, 4 * c, scale=(4 * c) ** -0.5).to(dtype), rnd(c, scale=0.02).to(dtype)]
            # a frozen stage runs K2 over its padded rows with the residual; a stage
            # that trains over its unpadded rows, the branch alone (drop-path is on)
            mrows = (x if frozen else x[:, :real[0], :real[1]]).reshape(-1, c)
            mkw = dict(residual=frozen)
            compare("K2", f"{dn} {name} b{batch} residual={frozen}", wa.mlp(mrows, *m, **mkw),
                    wa.mlp_plain(mrows, *m, **mkw), dtype,
                    cuda_ms(lambda: wa.mlp(mrows, *m, **mkw)),
                    cuda_ms(lambda: wa.mlp_plain(mrows, *m, **mkw)), depth,
                    mlp_work(mrows.shape[0], c, dtype), "train")
            d_ao = rnd(rows, c).to(dtype)
            for shift in (0, WINDOW // 2):
                case = f"{dn} {name} b{batch} shift={shift}"
                kw = dict(num_heads=heads, window=WINDOW, shift=shift)
                if frozen:
                    ln = dict(norm_w=1 + rnd(c, scale=0.1), norm_b=rnd(c, scale=0.1))
                    out = wa.block_step(x, **ln, **p, **kw, real_hw=real)
                    ref = wa.block_step_plain(x, **ln, **p, **kw, real_hw=real)
                    compare("K1", case, out[:, :real[0], :real[1]], ref[:, :real[0], :real[1]],
                            dtype, cuda_ms(lambda: wa.block_step(x, **ln, **p, **kw, real_hw=real)),
                            cuda_ms(lambda: wa.block_step_plain(x, **ln, **p, **kw, real_hw=real)),
                            depth // 2, block_work(rows, c, heads, dtype, 2), "train")
                    continue
                out, ao = wa.block_attention(x, **p, **kw, save_attn=True)
                ref, ref_ao, qkv = wa.block_attention_plain(x, **p, **kw)
                ms = cuda_ms(lambda: wa.block_attention(x, **p, **kw, save_attn=True))
                plain_ms = cuda_ms(lambda: wa.block_attention_plain(x, **p, **kw))
                compare("K4", case + " branch", out, ref, dtype, ms, plain_ms, depth // 2,
                        block_work(rows, c, heads, dtype, 3), "train")
                compare("K4", case + " attn_out", ao, ref_ao, dtype, ms, plain_ms, 0)

                geo = dict(batch=batch, hp=hp, wp=wp, **kw)
                dqkv, dtable = wa.window_attention_bwd(qkv, d_ao, p["table"], **geo)
                ref_dqkv, ref_dtable = wa.window_attention_bwd_plain(qkv, d_ao, p["table"], **geo)
                ms = cuda_ms(lambda: wa.window_attention_bwd(qkv, d_ao, p["table"], **geo))
                plain_ms = cuda_ms(
                    lambda: wa.window_attention_bwd_plain(qkv, d_ao, p["table"], **geo), reps=3)
                work = ((7 * rows * c) * esize(dtype)
                        + ((hp // WINDOW) * (wp // WINDOW) * heads * n * n
                           + (2 * WINDOW - 1) ** 2 * heads) * 4, 10.0 * rows * n * c)
                for j, part in enumerate(("dq", "dk", "dv")):
                    compare("K5", f"{case} {part}", dqkv[:, j * c:(j + 1) * c],
                            ref_dqkv[:, j * c:(j + 1) * c], dtype, ms, plain_ms,
                            depth // 2 if j == 0 else 0, work if j == 0 else None, "train")
                compare("K5", case + " dtable", dtable, ref_dtable, dtype, ms, plain_ms, 0)
                del ref_dqkv, ref_dtable, dqkv, ref, ref_ao, qkv

        for levels, tag, nb, calls in ((MSDA_LEVELS, f"384x640 pyramid b{batch}", batch, DET_LAYERS),
                                       (DET_LEVELS, "832x1344 pyramid", 2, 0)):
            args = msda_inputs(g, nb, levels, dtype)
            compare("K3", f"{dn} {tag}", msda_ops.msda(*args), msda_ops.msda_plain(*args),
                    dtype, cuda_ms(lambda: msda_ops.msda(*args)),
                    cuda_ms(lambda: msda_ops.msda_plain(*args), reps=3), calls,
                    msda_work(nb, args[0].shape[1], 150, 8, 64, 16, dtype, False), "train")
            dout = rnd(nb, 150, 512).to(dtype)
            grads = msda_ops.msda_bwd(dout, *args)
            refs = msda_ops.msda_bwd_plain(dout, *args)
            ms = cuda_ms(lambda: msda_ops.msda_bwd(dout, *args))
            plain_ms = cuda_ms(lambda: msda_ops.msda_bwd_plain(dout, *args), reps=3)
            work = msda_work(nb, args[0].shape[1], 150, 8, 64, 16, dtype, True)
            for j, part in enumerate(("dvalue", "dloc", "dattn")):
                compare("K6", f"{dn} {tag} {part}", grads[j], refs[j], dtype, ms, plain_ms,
                        calls if j == 0 else 0, work if j == 0 else None, "train")


def phase_yardsticks(batch: int) -> None:
    """Library calls at the kernels' sub-shapes, bf16, b8 inference shapes:
    no single PyTorch call computes K1-K6 whole, so these time the parts
    (F.linear for each GEMM launch, SDPA with an additive mask for the
    attention core).  Used nowhere in the port."""
    import torch.nn.functional as F

    g = torch.Generator(device=DEV).manual_seed(2)
    dt = torch.bfloat16
    n = WINDOW * WINDOW
    lin = sdpa = 0.0
    for name, c, heads, _, (hp, wp), depth in STAGES:
        rows = batch * hp * wp
        x = torch.randn(rows, c, generator=g, device=DEV).to(dt)
        h4 = torch.randn(rows, 4 * c, generator=g, device=DEV).to(dt)
        t = 0.0
        for a, (fo, fi) in ((x, (3 * c, c)), (x, (c, c)), (x, (4 * c, c)), (h4, (c, 4 * c))):
            w = torch.randn(fo, fi, generator=g, device=DEV).to(dt)
            b = torch.zeros(fo, device=DEV, dtype=dt)
            t += cuda_ms(lambda: F.linear(a, w, b))
        q, k, v = (torch.randn(rows // n, heads, n, 32, generator=g, device=DEV).to(dt)
                   for _ in range(3))
        mask = torch.randn(1, heads, n, n, generator=g, device=DEV).to(dt)
        ta = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        print(f"  yardstick {name}: F.linear x4 {t:.3f} ms, SDPA + mask {ta:.3f} ms a block")
        lin += t * depth
        sdpa += ta * depth
    YARDSTICKS.update({"linear_ms_per_b8_forward": lin, "sdpa_ms_per_b8_forward": sdpa})
    print(f"[yardsticks] per b{batch} bf16 forward (24 blocks): F.linear {lin:.2f} ms for the "
          f"K1 + K2 GEMMs, scaled_dot_product_attention {sdpa:.2f} ms for K1's attention core",
          flush=True)


def synthetic_batch(batch: int) -> ImageBatch:
    """uint8 images from a seed; every other image smaller than the bucket."""
    rng = np.random.default_rng(BATCH_SEED)
    imgs = np.zeros((batch, *HW, 3), np.uint8)
    mask = np.ones((batch, *HW), bool)
    for i in range(batch):
        h, w = HW if i % 2 == 0 else (HW[0] * 3 // 4, HW[1] * 4 // 5)
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask[i, :h, :w] = False
    return ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)).to(DEV)


def reset_launches() -> None:
    for d in (wa.LAUNCHES, msda_ops.LAUNCHES):
        for k in d:
            d[k] = 0


def phase_slice(batch: int, card: str) -> None:
    config = default_caption_config()
    vocab = config.model.vocab_size
    model = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0)
    samples = synthetic_batch(batch)
    # EOS set to an id outside the vocabulary: every beam runs all 20 steps
    gen = make_caption_generator(model, beam_size=BEAM, max_len=STEPS,
                                 bos_idx=config.model.bos_idx, eos_idx=vocab)
    gen(samples, batch)                      # warm-up (library handles, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = gen(samples, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = {"K1": wa.LAUNCHES["block_step"], "K2": wa.LAUNCHES["mlp"],
              "K3": msda_ops.LAUNCHES["msda"]}
    blocks = sum(s[-1] for s in STAGES)
    want = {"K1": blocks, "K2": blocks, "K3": DET_LAYERS}
    print(f"[slice] launches in one b{batch} caption batch: {counts} (want {want})")
    if counts != want:
        fail(f"kernel launch counts {counts} != {want}")
    for k, n in counts.items():
        RESULTS[k]["launches"] = n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the first timed batches still run slower (host-side warm-up), so the
    # rate is the median of TIMED_REPS more
    times = []
    for _ in range(TIMED_REPS):
        t0 = time.perf_counter()
        out = gen(samples, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = out.cpu()
    if tuple(out.shape) != (batch, STEPS) or out.min() < 0 or out.max() >= vocab:
        fail(f"captions: bad tokens, shape {tuple(out.shape)}")
    med = sorted(times)[TIMED_REPS // 2]
    print(f"[slice] b{batch} bf16 beam {BEAM} x {STEPS} steps at {HW[0]}x{HW[1]}: "
          f"{med * 1e3:.1f} ms/batch (median of {TIMED_REPS}; {min(times) * 1e3:.1f}-"
          f"{max(times) * 1e3:.1f}; the counted batch {first * 1e3:.1f}), "
          f"{batch / med:.2f} images/s, peak {peak:.2f} GiB  [{card}]", flush=True)
    RESULTS["slice"] = {"batch": batch, "first_s": first, "seconds": times,
                        "images_per_s": batch / med,
                        "peak_gib": peak}


def profile_run(fn, title: str, path: str) -> None:
    """torch.profiler over one call of ``fn``: device busy time and the
    kernels that take it, written to chiprun_out/<path>."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        # a profiler annotation (Optimizer.step#Adam.step) spans its kernels: not a kernel
        if (dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("Optimizer.")):
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    lines = [f"{title}: wall {wall * 1e3:.1f} ms, device busy "
             f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.3f}, "
             f"{sum(r[1] for r in rows)} kernel launches"]
    lines += [f"{us / 1e3:10.3f} ms {n:6d}x  {name[:110]}" for us, n, name in rows[:40]]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", path), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("[profile] " + "\n[profile] ".join(lines[:22]), flush=True)


def phase_profile(batch: int, card: str) -> None:
    """Profile one bf16 caption batch and one bf16 training step."""
    config = default_caption_config()
    model = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0)
    samples = synthetic_batch(batch)
    gen = make_caption_generator(model, beam_size=BEAM, max_len=STEPS,
                                 bos_idx=config.model.bos_idx,
                                 eos_idx=config.model.vocab_size)
    gen(samples, batch)
    torch.cuda.synchronize()
    profile_run(lambda: gen(samples, batch), f"b{batch} bf16 caption batch [{card}]",
                "profile.txt")
    del model, gen
    state, step, tbatch = training_setup(config, torch.bfloat16, TRAIN_BATCH)
    step(state, tbatch)
    torch.cuda.synchronize()
    profile_run(lambda: step(state, tbatch),
                f"b{TRAIN_BATCH} bf16 XE training step [{card}]", "profile_train.txt")


@contextlib.contextmanager
def plain_arm():
    """Swap the kernel wrappers for their plain versions, differentiated by
    autograd (comparison only)."""
    saved = wa.block_step, wa.mlp, msda_ops.msda, wa.block_attention_train
    wa.block_step, wa.mlp, msda_ops.msda = wa.block_step_plain, wa.mlp_plain, msda_ops.msda_plain
    wa.block_attention_train = wa.block_attention_train_plain
    try:
        yield
    finally:
        wa.block_step, wa.mlp, msda_ops.msda, wa.block_attention_train = saved


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


@torch.inference_mode()
def decoder_layer_errors(model, samples) -> list[float]:
    """Each deformable decoder layer, kernel against plain path on the same
    inputs: the plain path records every layer's inputs, and the kernel
    path's layers run on those instead of their own."""
    layers = model.detector.det_module.decoder_layers
    inputs, outs = {}, {"plain": {}, "kernel": {}}

    def hooked(arm, pre):
        return ([layer.register_forward_pre_hook(lambda mod, args, i=i: pre(i, args))
                 for i, layer in enumerate(layers)]
                + [layer.register_forward_hook(
                    lambda mod, args, out, i=i: outs[arm].__setitem__(i, out))
                   for i, layer in enumerate(layers)])

    for arm, pre in (("plain", lambda i, args: inputs.__setitem__(i, args)),
                     ("kernel", lambda i, args: inputs[i])):
        hooks = hooked(arm, pre)
        with plain_arm() if arm == "plain" else contextlib.nullcontext():
            model.detector(samples)
        for h in hooks:
            h.remove()
    return [max_rel(outs["kernel"][i], outs["plain"][i]) for i in range(len(layers))]


def rms_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).pow(2).mean() / b.pow(2).mean()).sqrt().item()


def phase_parity(batch: int) -> None:
    config = default_caption_config()
    vocab = config.model.vocab_size
    model = build_captioner(config, device=DEV, dtype=torch.float32, seed=0)
    samples = synthetic_batch(batch)
    det_out = []
    hook = model.detector.det_module.register_forward_hook(
        lambda mod, args, out: det_out.append(out))

    @torch.inference_mode()
    def run():
        vis = model.compute_vis(samples)
        kv = model.precompute_vis_kv(vis)
        res = beam_search(
            lambda tok, t, v, c: model.decode_step(tok, t, v, c, vis_kv=kv, vis_fold=BEAM),
            model.init_cache(batch * BEAM, STEPS), vis, batch, BEAM, STEPS,
            config.model.bos_idx, vocab, return_margins=True)
        return vis, res

    vis_k, res_k = run()
    with plain_arm():
        vis_p, res_p = run()
    hook.remove()
    for key in ("gri_feat", "reg_feat"):
        if not torch.isfinite(vis_k[key]).all():
            fail(f"parity: non-finite {key}")
    (hs_k, _, _), (hs_p, _, _) = det_out
    print("[parity] fp32 decoder state max rel err by layer, run freely: "
          + " ".join(f"{max_rel(hs_k[i], hs_p[i]):.3e}" for i in range(1, hs_k.shape[0])))
    errs = decoder_layer_errors(model, samples)
    print("[parity] fp32 decoder state max rel err by layer, same inputs: "
          + " ".join(f"{e:.3e}" for e in errs))
    for what, rel, tol in (("gri_feat", max_rel(vis_k["gri_feat"], vis_p["gri_feat"]),
                            FEATURE_TOL),
                           ("decoder layers on the same inputs", max(errs), FEATURE_TOL),
                           ("reg_feat", max_rel(vis_k["reg_feat"], vis_p["reg_feat"]),
                            REG_FEAT_TOL)):
        print(f"[parity] fp32 {what}: max rel err {rel:.3e} (tol {tol:.0e})", flush=True)
        if rel > tol:
            fail(f"parity: fp32 {what} max rel err {rel:.3e} > {tol:.0e}")

    bf16 = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0)
    bf16.detector.det_module.register_forward_hook(lambda mod, args, out: det_out.append(out))
    with torch.inference_mode():
        vis_b = bf16.compute_vis(samples)
    hs_b = det_out[-1][0]
    errs = [rms_rel(hs_b[lid], hs_p[lid]) for lid in range(1, hs_b.shape[0])]
    print("[parity] bf16 kernel path against fp32 plain path, decoder state relative RMS err "
          "by layer: " + " ".join(f"{e:.3e}" for e in errs), flush=True)
    checks = [("gri_feat", vis_b["gri_feat"], vis_p["gri_feat"], BF16_RMS_TOL),
              ("decoder layer 1", hs_b[1], hs_p[1], BF16_RMS_TOL),
              ("reg_feat", vis_b["reg_feat"], vis_p["reg_feat"], BF16_REG_RMS_TOL)]
    for what, a, b, tol in checks:
        err = rms_rel(a, b)
        print(f"[parity] bf16 kernel path against fp32 plain path, {what}: relative RMS err "
              f"{err:.3e} (tol {tol:.0e})", flush=True)
        if not torch.isfinite(a).all() or err > tol:
            fail(f"parity: bf16 {what} relative RMS err {err:.3e} > {tol:.0e}")
    seq_k = res_k.sequences[:, 0].cpu()
    seq_p = res_p.sequences[:, 0].cpu()
    margins = res_k.margins.cpu()
    same = (seq_k == seq_p).all(1)
    print(f"[parity] fp32 captions equal token for token on {int(same.sum())}/{batch} images")
    for i in torch.nonzero(~same).flatten().tolist():
        step = int(torch.nonzero(seq_k[i] != seq_p[i])[0])
        gap = float(margins[i, step])
        print(f"[parity] image {i}: first differing step {step}, decision margin there "
              f"{gap:.3e} (smallest over the run {float(margins[i].min()):.3e})")
        if gap > NEAR_TIE:
            fail(f"parity: image {i} captions differ without a near-tie ({gap:.3e})")


SCHED = dict(num_epochs=10, num_its_per_epoch=1000, init_lr=1e-4, min_lr=1e-4,
             warmup_init_lr=1e-5)


def training_batch(batch: int, config) -> dict:
    """Synthetic XE batch from a seed: the inference phase's images, and
    captions of CAPTION_LEN tokens (BOS, random words, EOS, then a pad tail of
    0-7 tokens)."""
    rng = np.random.default_rng(1000 + BATCH_SEED)
    m = config.model
    caps = rng.integers(4, m.vocab_size, (batch, CAPTION_LEN))
    caps[:, 0] = m.bos_idx
    for i in range(batch):
        end = CAPTION_LEN - 1 - i % 8
        caps[i, end] = m.eos_idx
        caps[i, end + 1:] = m.pad_idx
    return {"samples": synthetic_batch(batch), "captions": torch.from_numpy(caps).to(DEV)}


def training_setup(config, dtype, batch: int, dropouts: bool = True):
    """The XE trainer a user would build: model in train() with f32 master
    parameters computing in ``dtype``, two-group Adam with the frozen Swin
    stages left out, the cosine schedule, a seeded generator for the masks."""
    config = config.copy()
    config.model.frozen_stages = FROZEN_STAGES
    model = build_captioner(config, device=DEV, dtype=dtype, seed=0, train=True)
    if not dropouts:
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
            elif isinstance(mod, SwinBlock):
                mod.drop_path_rate = 0.0
    freeze = optim_lib.frozen_mask(model, optim_lib.swin_frozen_stages_predicate(FROZEN_STAGES))
    opt = optim_lib.build_optimizer(
        model, model_lr=SCHED["init_lr"], backbone_lr=config.optimizer.xe_backbone_lr,
        beta_1=config.optimizer.beta_1, beta_2=config.optimizer.beta_2, freeze=freeze)
    state = xe_lib.TrainState(model, opt, global_steps=1,
                              generator=torch.Generator(device=DEV).manual_seed(0))
    step = xe_lib.make_xe_train_step(pad_idx=config.model.pad_idx, sched_cfg=SCHED)
    return state, step, training_batch(batch, config)


def train_launches() -> dict:
    return {"K1": wa.LAUNCHES["block_step"], "K2": wa.LAUNCHES["mlp"],
            "K3": msda_ops.LAUNCHES["msda"], "K4": wa.LAUNCHES["block_attention"],
            "K5": wa.LAUNCHES["window_attention_bwd"], "K6": msda_ops.LAUNCHES["msda_bwd"]}


def phase_train(card: str) -> None:
    batch = TRAIN_BATCH
    state, step, tbatch = training_setup(default_caption_config(), torch.bfloat16, batch)
    _, metrics = step(state, tbatch)                      # warm-up
    losses = [float(metrics["loss"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, metrics = step(state, tbatch)
    losses.append(float(metrics["loss"]))
    counts = train_launches()
    frozen = sum(s[-1] for s in STAGES[:FROZEN_STAGES - 1])
    trained = sum(s[-1] for s in STAGES[FROZEN_STAGES - 1:])
    want = {"K1": frozen, "K2": frozen + trained, "K3": DET_LAYERS, "K4": trained,
            "K5": trained, "K6": DET_LAYERS}
    print(f"[train] launches in one b{batch} XE step: {counts} (want {want})")
    if counts != want:
        fail(f"training kernel launch counts {counts} != {want}")
    for k, n in counts.items():
        RESULTS[k]["launches_train"] = n
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, metrics = step(state, tbatch)
        losses.append(float(metrics["loss"]))             # synchronises
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, loss in enumerate(losses):
        print(f"[train] step {i}: loss {loss:.4f}")
    # the validation loss of the same model in eval(): every stage through K1 and K2
    eval_loss = float(xe_lib.make_eval_loss_step(state.model, pad_idx=state.model.cap_generator.pad_idx)(tbatch))
    print(f"[train] validation loss in eval() after {len(losses)} steps: {eval_loss:.4f}")
    if not all(np.isfinite(losses + [eval_loss])) or not eval_loss < losses[0]:
        fail(f"training: loss {losses}, validation {eval_loss}: non-finite or not below the start")
    for name, prm in state.model.named_parameters():
        if prm.dtype != torch.float32 or not torch.isfinite(prm).all():
            fail(f"training: parameter {name} is {prm.dtype} or non-finite")
    med = sorted(times)[len(times) // 2]
    print(f"[train] b{batch} bf16 XE step at {HW[0]}x{HW[1]}, frozen_stages={FROZEN_STAGES}: "
          f"{med * 1e3:.1f} ms/step (median of {len(times)}; {min(times) * 1e3:.1f}-"
          f"{max(times) * 1e3:.1f}), {batch / med:.2f} images/s, peak {peak:.2f} GiB, "
          f"lr {metrics['lr']:.3e}  [{card}]", flush=True)
    RESULTS["train"] = {"batch": batch, "losses": losses, "seconds": times,
                        "images_per_s": batch / med, "peak_gib": peak, "launches": counts}


# module groups whose gradient leaves share what can flip upstream of them
PARITY_GROUPS = (("cap_generator", "cap_generator."), ("grid_net", "grid_net."),
                 ("deformable decoder", "detector.det_module."),
                 ("input_proj", "detector.input_proj."), ("swin", "detector.backbone."))


def group_of(name: str) -> str:
    return next((g for g, key in PARITY_GROUPS if key in name), "other")


@contextlib.contextmanager
def float64_arm():
    """The plain path in float64 (comparison only): with the model's
    parameters in float64, every ``.float()`` upcast in the plain versions and
    the model, which means "accumulate in at least f32", reads as
    ``.double()``."""
    saved = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        with plain_arm():
            yield
    finally:
        torch.Tensor.float = saved


def parity_arm(arm: str, batch: int):
    """One fp32 XE step, dropouts off, from the seed's weights and batch,
    through the kernels ("kernel"), the plain versions ("plain") or the plain
    versions in float64 ("float64") -> (loss, {name: gradient}, {name:
    (update, learning rate or None, the parameter's max before)})."""
    config = default_caption_config()
    # the float64 arm recomputes each Swin block in its backward: the same
    # arithmetic in less memory
    config.model.use_checkpoint = arm == "float64"
    state, step, tbatch = training_setup(config, torch.float32, batch, dropouts=False)
    model = state.model
    hooks = []
    if arm == "float64":
        to_compute_dtype(model.double(), torch.float64, master_f32=True)

        def is_f64(mod, args, out):
            if (isinstance(out, torch.Tensor) and out.is_floating_point()
                    and out.dtype != torch.float64):
                fail(f"training parity: float64 arm computed {type(mod).__name__} "
                     f"in {out.dtype}")
        hooks = [m.register_forward_hook(is_f64) for m in model.modules()]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with {"kernel": contextlib.nullcontext, "plain": plain_arm, "float64": float64_arm}[arm]():
        _, metrics = step(state, tbatch)
    for h in hooks:
        h.remove()
    launched = sum(train_launches().values())
    if (arm == "kernel") != (launched > 0):
        fail(f"training parity: the {arm} arm launched {launched} kernels")
    lrs = {id(p): g["lr"] for g in state.optimizer.param_groups for p in g["params"]}
    loss = float(metrics["loss"])
    print(f"[train parity] {arm} arm: loss {loss:.9f}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB", flush=True)
    return (loss, {n: p.grad for n, p in model.named_parameters()},
            {n: (p.detach() - before[n], lrs.get(id(p)), before[n].abs().max().item())
             for n, p in model.named_parameters()})


def module_grad_errors(batch: int) -> dict[str, tuple[float, str]]:
    """The backward of every module that holds a kernel with a backward,
    kernel against plain, on the same inputs and the same output gradient:
    one plain-path forward and backward of the whole model records each
    module's inputs and the gradient that reaches its output; then each
    module runs alone, through its kernels and through their plain versions.
    The modules are the 22 Swin blocks that train (K4, K5, K2) and the six
    deformable cross-attentions (K3, K6); neither holds a ReLU, and both arms
    compute the same sampling locations, so nothing can flip.  -> per Swin
    stage and per decoder layer, the worst gradient leaf (parameters and the
    inputs that carry gradients upstream) as a share of the leaf's max, and
    its name."""
    state, _, tbatch = training_setup(default_caption_config(), torch.float32, batch,
                                      dropouts=False)
    model = state.model.train()
    swin = model.detector.backbone
    # label -> (module, the method the model calls, inputs with a gradient, launches alone)
    targets = {f"swin stage {i + 1} block {j + 1}": (blk, "forward_train", (0,), 3)
               for i, layer in enumerate(swin.layers) if i >= FROZEN_STAGES - 1
               for j, blk in enumerate(layer.blocks)}
    targets.update({f"cross-attention {i + 1}": (layer.cross_attn, "forward", (0, 2), 2)
                    for i, layer in enumerate(model.detector.det_module.decoder_layers)})
    rec: dict[str, list] = {}

    def recording(label, fn):
        def wrapper(*args):
            out = fn(*args)
            rec[label] = [args, None]
            out.register_hook(lambda g: rec[label].__setitem__(1, g))
            return out
        return wrapper

    for label, (mod, method, _, _) in targets.items():
        setattr(mod, method, recording(label, getattr(mod, method)))   # shadows the class's
    with plain_arm():
        out = model(tbatch["samples"], tbatch["captions"])
        xe_lib.nll_loss(out, tbatch["captions"], model.cap_generator.pad_idx)[0].backward()
    del out
    worst: dict[str, tuple[float, str]] = {}
    for label, (mod, method, grad_ins, want) in targets.items():
        delattr(mod, method)
        args, gout = rec.pop(label)
        grads = {}
        for arm in ("kernel", "plain"):
            ins = [a.detach().requires_grad_() if k in grad_ins else
                   a.detach() if isinstance(a, torch.Tensor) else a for k, a in enumerate(args)]
            mod.zero_grad(set_to_none=True)
            reset_launches()
            with plain_arm() if arm == "plain" else contextlib.nullcontext():
                getattr(mod, method)(*ins).backward(gout)
            launched = sum(train_launches().values())
            if launched != (want if arm == "kernel" else 0):
                fail(f"training parity: {label} alone launched {launched} kernels in the "
                     f"{arm} arm")
            grads[arm] = {**{f"input {k}": ins[k].grad for k in grad_ins},
                          **{n: p.grad for n, p in mod.named_parameters()}}
        err = max((((grads["kernel"][n] - g).abs().max()
                    / g.abs().max().clamp(min=GRAD_FLOOR)).item(), f"{label} {n}")
                  for n, g in grads["plain"].items())
        group = label.split(" block")[0]
        worst[group] = max(worst.get(group, (0.0, "")), err)
    return worst


def phase_train_parity(batch: int) -> None:
    """fp32, dropouts and drop-path off, the training step's own batch: one
    XE step through the kernels, one through the plain versions, and one
    through the plain versions in float64, from the same weights and batch;
    the float64 step is the yardstick of both.  Then every module that holds
    a kernel with a backward alone on the same inputs, where nothing can flip
    and the bound is tight."""
    (loss_k, grad_k, upd_k), (loss_p, grad_p, _), (loss_r, grad_r, _) = (
        parity_arm(arm, batch) for arm in ("kernel", "plain", "float64"))
    torch.cuda.empty_cache()
    rel_k, rel_p = abs(loss_k - loss_r) / abs(loss_r), abs(loss_p - loss_r) / abs(loss_r)
    print(f"[train parity] fp32 b{batch} loss against float64: kernel rel err {rel_k:.3e}, "
          f"plain {rel_p:.3e} (tol {LOSS_TOL:.0e})")
    if not np.isfinite(loss_k) or rel_k > LOSS_TOL:
        fail(f"training parity: loss rel err {rel_k:.3e} > {LOSS_TOL:.0e}")
    worst: dict[str, list] = {}
    failures = []
    for name, gr in grad_r.items():
        gk, gp = grad_k[name], grad_p[name]
        upd, lr, pmax = upd_k[name]
        if (gr is None) != (gk is None) or (gr is None) != (gp is None):
            fail(f"training parity: {name} has a gradient in some arms only")
        if gr is None or lr is None:
            if upd.any():
                fail(f"training parity: {name} is frozen or off the path and moved")
            continue
        scale = gr.abs().max().clamp(min=GRAD_FLOOR)
        k_err = ((gk - gr).abs().max() / scale).item()
        p_err = ((gp - gr).abs().max() / scale).item()
        # the kernel arm took Adam's first step on its own gradient (an update is
        # read as a difference of f32 parameters: allow their rounding, 2^-23 of the max)
        a_err = max(0.0, (upd + lr * gk / (gk.abs() + 1e-8)).abs().max().item()
                    - 1.2e-7 * pmax) / lr
        rec = worst.setdefault(group_of(name), [0.0, 0.0, 0.0, ""])
        if k_err > rec[0]:
            rec[3] = name
        for j, v in enumerate((k_err, p_err, a_err)):
            rec[j] = max(rec[j], v)
        if not k_err <= FLIP_TOL:
            failures.append(f"{name} gradient err {k_err:.3e} > {FLIP_TOL}")
        if not a_err <= UPDATE_TOL:
            failures.append(f"{name} update err {a_err:.3e} of lr > {UPDATE_TOL:.0e}")
    del grad_k, grad_p, grad_r, upd_k
    torch.cuda.empty_cache()
    print(f"[train parity] worst leaf by module group, against float64: the kernel path's "
          f"gradient err (share of the leaf's max; tol {FLIP_TOL}), the plain path's, and "
          f"the kernel path's update against Adam's step (share of lr; tol {UPDATE_TOL:.0e})")
    for group, (k_err, p_err, a_err, name) in worst.items():
        print(f"[train parity]   {group:<18} kernel {k_err:.3e}  plain {p_err:.3e}  "
              f"adam {a_err:.3e}  ({name})", flush=True)
    alone = module_grad_errors(batch)
    print(f"[train parity] each module alone on the same inputs and output gradient, kernels "
          f"against plain, worst gradient leaf (tol {SAME_INPUT_TOL:.0e}):")
    for group, (err, name) in alone.items():
        print(f"[train parity]   {group:<18} {err:.3e}  ({name})", flush=True)
        if not err <= SAME_INPUT_TOL:
            failures.append(f"{name} alone: gradient err {err:.3e} > {SAME_INPUT_TOL:.0e}")
    RESULTS["train_parity"] = {
        "loss_rel_err": rel_k, "plain_loss_rel_err": rel_p,
        "groups": {g: {"kernel": v[0], "plain": v[1], "adam": v[2], "leaf": v[3]}
                   for g, v in worst.items()},
        "alone_same_inputs": {g: e for g, (e, _) in alone.items()}}
    if failures:
        fail("training parity: " + "; ".join(failures[:10]))


def parity_seeds(batch: int, seeds: int) -> None:
    """The three arms of the training parity at further batch seeds: how the
    two fp32 paths' distances from float64 spread from batch to batch
    (reported, not bounded)."""
    global BATCH_SEED
    spread = []
    for BATCH_SEED in range(1, seeds + 1):
        (_, grad_k, _), (_, grad_p, _), (_, grad_r, _) = (
            parity_arm(arm, batch) for arm in ("kernel", "plain", "float64"))
        worst: dict[str, list] = {}
        for name, gr in grad_r.items():
            if gr is not None:
                scale = gr.abs().max().clamp(min=GRAD_FLOOR)
                rec = worst.setdefault(group_of(name), [0.0, 0.0])
                for j, g in enumerate((grad_k[name], grad_p[name])):
                    rec[j] = max(rec[j], ((g - gr).abs().max() / scale).item())
        print(f"[parity seeds] batch seed {BATCH_SEED}, worst leaf against float64, kernel / plain: "
              + ", ".join(f"{g} {k:.2e} / {p:.2e} ({k / p:.2f}x)" for g, (k, p) in worst.items()),
              flush=True)
        spread.append(worst)
        del grad_k, grad_p, grad_r
        torch.cuda.empty_cache()
    BATCH_SEED = 0
    RESULTS["parity_seeds"] = spread


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bf16 caption batch and one bf16 training step")
    ap.add_argument("--parity-seeds", type=int, default=0, metavar="N",
                    help="also report the training parity's gradient errors at N further "
                         "batch seeds")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # fp32 means fp32: no TF32 in cuBLAS or in cuDNN's convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    print(f"[build] kernel library ready in {build_s:.1f} s", flush=True)

    phase_kernels(args.batch)
    phase_train_kernels(TRAIN_BATCH)
    phase_yardsticks(args.batch)
    phase_slice(args.batch, card)
    phase_parity(args.batch)
    phase_train(card)
    if args.profile:
        phase_profile(args.batch, card)
    phase_train_parity(TRAIN_BATCH)
    parity_seeds(TRAIN_BATCH, args.parity_seeds)

    swin, msda = "grit_tpu_torch/csrc/swin_block.cu", "grit_tpu_torch/csrc/msda.cu"
    # name: (source, TPU kernel it replaces, the run its launches, ms and bound are of)
    sources = {"K1": (swin, "grit_tpu/ops/window_attention.py:1029", "caption"),
               "K2": (swin, "grit_tpu/ops/window_attention.py:1819", "caption"),
               "K3": (msda, "grit_tpu/ops/msda_pallas.py:1018", "caption"),
               "K4": (swin, "grit_tpu/ops/window_attention.py:385", "train"),
               "K5": (swin, "grit_tpu/ops/window_attention.py:197", "train"),
               "K6": (msda, "grit_tpu/ops/msda_pallas.py:633", "train")}
    kernels = []
    for k, (src, rep, run) in sources.items():
        r = RESULTS[k]
        acc, train = r[run], r["train"]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            "launches": r["launches"] if run == "caption" else r["launches_train"],
            "max_abs_err": r["max_abs_err"], "ms": acc["ms"], "plain_ms": acc["plain_ms"],
            "bound_ms": max(acc["bytes_ms"], acc["ops_ms"]),
            "bound_by": "bytes" if acc["bytes_ms"] >= acc["ops_ms"] else "operations",
            # no single PyTorch call computes any of these whole; the parts'
            # yardsticks are in chip_smoke.json
            "library_ms": None,
            "per": f"b{args.batch} bf16 caption forward" if run == "caption"
                   else f"b{TRAIN_BATCH} bf16 XE training step",
            # the same four for one b16 bf16 XE training step, whichever run
            # the keys above are of
            "launches_caption": r.get("launches", 0), "launches_train": r["launches_train"],
            "train_ms": train["ms"], "train_plain_ms": train["plain_ms"],
            "train_bound_ms": max(train["bytes_ms"], train["ops_ms"])})
    # K7a / K7b: the S-chunked TPU variants map onto K3 / K6, checked at 832x1344
    mapped = [{"name": name, "maps_onto": onto, "replaces": rep, "checked": [
                   c for c in DETAIL if c["kernel"] == onto and "832x1344" in c["case"]]}
              for name, onto, rep in (("K7a", "K3", "grit_tpu/ops/msda_pallas.py:1259"),
                                      ("K7b", "K6", "grit_tpu/ops/msda_pallas.py:1324"))]
    if not all(m["checked"] for m in mapped):
        fail("K7a/K7b: no check at the 832x1344 pyramid ran")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "build_s": build_s,
                   "kernels": kernels,
                   "mapped": mapped, "yardsticks": YARDSTICKS, "cases": DETAIL,
                   "slice": RESULTS.get("slice"), "train": RESULTS.get("train"),
                   "train_parity": RESULTS.get("train_parity"),
                   "parity_seeds": RESULTS.get("parity_seeds")}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
