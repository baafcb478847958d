"""GPU smoke test of the PyTorch/CUDA port (grit_tpu_torch) on one card.

  python3 chip_smoke.py              # every phase
  python3 chip_smoke.py --profile    # and torch.profiler passes over a b8 and a
                                     # b128 caption batch and the training steps
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
     K11 (the caption generator's decode-layer tail) at the decode shapes of
     a b8 and a b128 caption batch, beside the module path for the same tail;
     K3 and K6 once more at the shapes of a b8 and a b128 caption forward, a
     b16 XE step and a b4 detector step (K6 but at b128), timed by CUDA-graph
     replay, their launches a call counted from a captured graph and K6's
     split into zero-fill, kernel and casts, each bit-equal over two calls
     (K3's output, K6's location and weight gradients);
     K12 (the multi-tensor Adam update) for three steps on the captioner's
     own trainable leaves, beside torch.optim.Adam(fused=True);
  3. the kernels that do most of K1, K2, K4, K5 and K10a's work: the GEMM
     in bf16 (csrc/gemm_sm90.cu: TMA, an mbarrier ring, wgmma) and in fp32
     (swin_block.cu: a register-blocked, pipelined SIMT tile), the bf16
     window-attention core (csrc/window_attn_mma.cu: mma.sync tiles) and the
     bf16 attention backward (csrc/win_attn_bwd_mma.cu: mma.sync tiles, the
     batch split over blocks), each at every shape at which a b8 caption
     forward, a b16 XE step and a b4 832x1344 detector step launch it
     (the backward at the two training runs; the fp32 core and backward,
     csrc/win_attn_f32.cu's register micro-tiles, the backward's batch split
     over blocks, at the two training runs, fp32 being both training CLIs'
     default), against its plain version
     and beside one PyTorch call for the same function (F.linear a GEMM
     launch; scaled_dot_product_attention with an additive mask a core
     launch; its backward with the mask requiring grad a backward launch,
     net of the forward), timed as device time by CUDA-graph replay and used
     nowhere in the port; the backward's bias gradient must be the same bit
     for bit over two calls;
  4. the inference path: batch caption inference at the full width of the
     shipped GRIT model on random weights (seed 0), bf16, beam 5, 20 steps,
     through grit_tpu_torch.engine.evaluator.make_caption_generator, with
     each kernel's launch count checked against one forward's calls (K11:
     layers x steps) and the batch's device launches counted; then one timed
     b128 batch (the device-bound case): ms/batch, images/s, peak memory;
  5. the same model in fp32, kernel path against plain path: features within
     tolerance, captions token for token (a difference only at a near-tie:
     at the first differing step, the gap between adjacent candidates among
     the top beam+1 must be <= 1e-3); then the bf16 kernel path's features
     against the fp32 plain path's; the plain path's decode layers take the
     module path, the kernel path's K11;
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
     is tight;
  8. the caption trainer's path at full width (between 6 and 7), through the
     trainer's own loops over in-memory loaders: train_xe_epoch over two b16
     batches, train_sc_epoch over two b8 batches (beam-5 generation, CIDEr
     rewards on the host, the update through K12), evaluate_metrics over two
     b16 batches in eval() (through K11), and a checkpoint saved, restored
     into a fresh model and optimizer and held to the same next loss.  Its
     shapes (K1-K3 at b16, K1-K6 at b8, K11 at 80 rows) are among phase 2's;
  9. among phase 2's kernels also: K10a (PatchMerging's gather, LayerNorm and
     reduction) and K10b (the patch-embed LayerNorm), which every Swin forward
     above runs (4 and 1 launches, counted in phases 4, 6 and 8), forward and
     gradients, beside F.layer_norm + F.linear; K8 (window attention on
     separate q, k, v and a dense bias), forward and backward, beside
     scaled_dot_product_attention, which no model path reaches and this phase
     holds; and K1-K6 at the shapes of a b4 batch in the detector's 832x1344
     bucket (504 windows an image at stage 1; a last merge of 13x21 -> 14x22);
 10. detector pre-training at full width (between 8 and 7), b4 at 832x1344,
     the whole Swin training, in fp32 (the CLI's type) and in bf16 over f32
     master parameters, through detection.solver.Trainer.run_epoch over
     in-memory loaders with the CLI's hooks: a warm-up epoch, then steps whose
     kernel launches are checked one by one, Valider.run_epoch -> postprocess
     -> CocoEvaluator over two batches in eval(), and the checkpoint hook's
     detector_last restored into a fresh model and held to the same next loss;
 11. detector parity in fp32 (last), b2: one step through the kernels and one
     through the plain versions against one through the plain versions in
     float64, whose Hungarian assignments all three use: assignments, the
     total and every named loss, every clipped gradient leaf by module group,
     and the update against AdamW's step.
 12. the decoders and entry points (between 8 and 10;
     phase_decoders_and_entry_points): the sequential and concat decoders
     (b8 bf16 caption batches, their fp32 captions against the plain path's,
     a b16 bf16 XE step each), greedy_search, beam_search with
     return_all_probs, a two-member ensemble, the online and nocaps CLIs'
     caption loop over two b16 batches (the online one in its 640x640 bucket,
     whose Swin maps pad H and W at every stage; K1, K2, K3, K10a and K10b are
     held to their plain versions at b16 in that bucket, fp32 and bf16, in
     phase 2 and 9), feature extraction over four b16 batches and two
     freezing-mode XE steps at b64 on its float16 features, each path's
     kernel launches counted from 0 around its run;
 13. ln_rows_kernel and ln_merge_kernel (the LayerNorm launches inside K1,
     K2, K10b and K10a) alone at each shape of the b8 and b128 caption
     forwards (bf16) and the b4 832x1344 detector step (fp32 and bf16) and
     on an odd map: device time by graph replay beside its bound and
     F.layer_norm, held to the plain version and bit-equal from call to call
     (phase_ln_kernels);
     phase 9's K8 backward also beside SDPA's backward with the mask
     requiring grad.  Each phase's seconds are printed ([time] lines).
 14. the other Swin presets (after 10; the "presets" phases): large (C 192,
     window 12), small and tiny (C 96, window 7), nano (C 64, window 7), at
     full width on random weights.  K1, K2, K10a and K10b at each one's b8
     caption shapes, K4 and K5 at swin_small's and swin_large's b16 XE
     shapes and swin_tiny's b4 detector shapes, fp32 and bf16, against their
     plain versions; the GEMM (its N and K tails), the core and the backward
     (N = 49) at those shapes beside F.linear, SDPA and SDPA's backward; a b8
     bf16 caption batch on each (beam 5, 20 steps, EOS off, launches
     checked, profiled); fp32 captions of tiny and large token for token
     with the plain path; a b16 bf16 XE step on small and large; swin_tiny
     detector steps in fp32 and bf16 through Trainer.run_epoch; and
     swin_tiny's fp32 training parity against float64 at b4.
 15. data parallel (after 14; phase_data_parallel): two ranks under
     DistributedDataParallel at full width, started by
     grit_tpu_torch.parallel.distributed.run_ranks after the kernels are
     built here, on two cards over NCCL or, with one card, both on it over
     gloo (passed explicitly: NCCL refuses a card twice), against one process
     on the same inputs: the rank-specialised caption evaluation (valid on
     rank 0, test on rank 1, scores exchanged), an fp32 XE step at b16 global
     (8 a rank), three timed bf16 XE steps (launches as one process's step;
     --profile: the all-reduce's device and host time), an fp32 SCST update
     at b8 global, the sharded detector validation merged to one process's
     mAP, and an fp32 detector step at b4 832x1344 global with one process's
     Hungarian assignments; then NCCL at world 1 through maybe_initialize
     from torchrun's variables (an all-reduce of the XE gradient's size) and
     grit_tpu_torch.dryrun.dryrun_multichip(2, "cuda").
 16. the detector's set matcher (phase_lsa_kernel, with the kernel phases):
     grit_lsa (csrc/lsa.cu, the JAX package's on-device Hungarian solver,
     _device_lsa_single) against its plain version at the detector step's
     [28, 150, 100] problems, fills 0/1/20/57/100, on continuous and on
     integer (tied) costs: assignments equal, totals scipy's optimum,
     bit-equal over two calls, one launch; its device ms by graph replay
     and ns an iteration of the longest problem's Dijkstra chain (counted by
     lsa_plain) beside the host path's (.cpu() + scipy).  In phase 10 each
     step matches on the card (one grit_lsa launch a step, counted), the
     criterion alone waits for no device copy
     (torch.cuda.set_sync_debug_mode("error")), the device and host solvers'
     assignments agree on the step's own costs, and steps under
     match_impl="host" and "device" are timed in turns and profiled (idle
     share, grit_lsa's device ms); phase 11's float64 arm still matches on
     the host and grit_lsa is held to it on the same costs;
 17. the native metric library (phase_native_metrics, before phase 8): built
     with g++ from grit_tpu_torch/native/fastmetrics.cpp, its tokenizer and
     CIDEr-D against the pure-Python versions on a 5000-image corpus, timed;
     phase 8's SCST rewards, which it now scores, held to the Python scorer's
     to 1e-10;
 18. the measuring tools (phase_tools, before 15): python -m
     grit_tpu_torch.tools.bench_train --phase both, profile_eval 8 --trace,
     agg_trace on that trace, bench_epoch --images 32 in a temporary
     directory.
 19. tensor parallel (after 15; phase_tensor_parallel): grit_tpu's model
     axis, Swin-B's MLPs and the grid net's and decoder's FFNs split over two
     ranks (the 10201-wide vocab head stays whole), on two cards over NCCL
     or both on this one over gloo, against one process: the b8 caption
     batch's fp32 tokens, its bf16 features (and their error against fp32
     beside one process's), K2 24 and the split K11 60 + 60 launches a rank,
     one b16 bf16 XE step's loss and updates, times at tp1 and tp2, the
     collectives' count and bytes; then dryrun_multichip(4, "cuda") in dp4
     and dp2tp2.  Its kernels, with phase 2's (phase_tp_kernels): K11's
     split (the partial mode of csrc/decode_layer.cu's chain, launches 1-7 on
     a rank's half of d_ff, and its finish entry, one launch) at 40, 80 and
     640 rows, fp32 and bf16, against their plain versions, bit-equal over
     two calls, 7 + 1 launches a call; K2 on a rank's half of each Swin-B
     stage's hidden units against mlp_plain.
 20. the routed experts of the mla_moe caption decoder (phase_moe_experts,
     with the kernel phases): ops/moe.py's path (rows sorted by expert, the
     library's grouped GEMM torch._grouped_mm for gate+up and for down) at
     the benchmark's Kimi-VL-A3B shapes, a decode step's 640 rows and a b128
     prefill's 128 x 211, 64 experts of 1408 over hidden 2048, 6 a row,
     against the same arithmetic expert by expert: within 1e-2 of the
     output's largest magnitude, bit-equal over two calls, one grouped GEMM
     kernel a product (the one moe_roofline.caption counts); device ms
     beside the bound and the loop; then a tiny mla_moe captioner in bf16
     through make_caption_generator, its grouped GEMM calls counted from 0.

Prints the card's name and power limit as nvidia-smi reports them, a JSON
line of per-kernel results (all 18 TPU kernel bodies: the eleven ported
kernels, and the seven bodies that one of them serves; the kernels
inside K1, K2, K4, K5, K8 and K10a: gemm_bf16, win_attn and win_attn_bwd, and
gemm_f32, win_attn_f32 and win_attn_bwd_f32; grit_lsa, which ports no
Pallas body; and K11's two tensor-parallel entries, "K11 partial" and "K11
finish"), and last {"ok": true, "device": {...}}; the
per-shape results go to chiprun_out/chip_smoke.json.  Exits non-zero, without
that last line, when there is no CUDA device or any phase fails.  The JSON
file also holds the LN kernels' rows, the decoders phase's numbers, the
presets' paths ("presets") and their kernels' sums a run ("yardsticks", by
run and preset), and each phase's seconds.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


try:
    import numpy as np
    import torch

    from grit_tpu_torch.config import default_caption_config, default_detection_config
    from grit_tpu_torch.decoding.beam_search import beam_search, greedy_search
    from grit_tpu_torch.dryrun import dryrun_multichip, one_process_xe_step
    from grit_tpu_torch.data.field import TextField
    from grit_tpu_torch.data.metrics import Cider, PTBTokenizer
    from grit_tpu_torch.data.vocab import SPECIALS, Vocab
    from grit_tpu_torch.detection import hooks as det_hooks
    from grit_tpu_torch.detection import losses as det_losses
    from grit_tpu_torch.detection import solver as det_solver
    from grit_tpu_torch.detection.coco_eval import CocoEvaluator
    from grit_tpu_torch.detection.detector import build_detection_model
    from grit_tpu_torch.engine import checkpoint as ckpt_lib
    from grit_tpu_torch.engine import loops as loops_lib
    from grit_tpu_torch.engine import optim as optim_lib
    from grit_tpu_torch.engine import scst as scst_lib
    from grit_tpu_torch.engine import xe as xe_lib
    from grit_tpu_torch.engine.evaluator import (caption_batches, evaluate_metrics,
                                                 evaluate_splits, make_caption_generator)
    from grit_tpu_torch.eval_caption_online import ONLINE_BATCH, ONLINE_BUCKET
    from grit_tpu_torch.models import cap_generator as cap_generator_lib
    from grit_tpu_torch.models.captioner import build_captioner, build_detector, to_compute_dtype
    from grit_tpu_torch.models.ensemble import make_ensemble_generator
    from grit_tpu_torch.models.layers import Dropout
    from grit_tpu_torch.models.swin import BACKBONES, SwinBlock
    from grit_tpu_torch.ops import _cuda
    from grit_tpu_torch.ops import decode_layer as tail_ops
    from grit_tpu_torch.ops import fused_adam as adam_ops
    from grit_tpu_torch.ops import lsa as lsa_ops
    from grit_tpu_torch.ops import msda as msda_ops
    from grit_tpu_torch.ops import window_attention as wa
    from grit_tpu_torch.parallel import distributed as dist_lib
    from grit_tpu_torch.parallel import tensor as tp_ops
    from grit_tpu_torch.parallel.mesh import (exclude_untrained, gather_tp_state, global_sum,
                                              make_groups, shard_batch, shard_model,
                                              split_params, tie_replicated_grads, tp_plan,
                                              wrap_data_parallel)
    from grit_tpu_torch.parallel.tensor import tp_size
    from grit_tpu_torch.tools.extract_features import FEATURES, collect_vis_features
    from grit_tpu_torch.utils.nested import ImageBatch, to_device
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
# Swin-B stage maps of the detector's 832x1344 bucket: 504 windows an image at
# stage 1, and a last merge that pads 13x21 to 14x22
DET_HW, DET_BATCH = (832, 1344), 4
DET_STAGES = [
    ("stage1", 128, 4, (208, 336), (216, 336), 2),
    ("stage2", 256, 8, (104, 168), (108, 168), 2),
    ("stage3", 512, 16, (52, 84), (60, 84), 18),
    ("stage4", 1024, 32, (26, 42), (36, 48), 2),
]
# Swin-B stage maps of the online evaluation's 640x640 bucket: H and W pad to
# window multiples at every stage, and the MSDA pyramid is square
ONLINE_STAGES = [
    ("stage1", 128, 4, (160, 160), (168, 168), 2),
    ("stage2", 256, 8, (80, 80), (84, 84), 2),
    ("stage3", 512, 16, (40, 40), (48, 48), 18),
    ("stage4", 1024, 32, (20, 20), (24, 24), 2),
]
ONLINE_LEVELS = ((80, 80), (40, 40), (20, 20), (10, 10))
RUNS = ("caption", "train", "detector")
TRAIN_BATCH, CAPTION_LEN, FROZEN_STAGES, TRAIN_STEPS = 16, 20, 2, 6
SC_BATCH = TRAIN_BATCH // 2     # optimizer.batch_size // optimizer.sc_batch_divisor
EVAL_BATCH = SC_BATCH * 2       # the dict loaders' evaluation batch
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
YARDSTICKS: dict[str, object] = {}


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


def graph_ms(fn, reps: int = 10) -> float:
    """Device milliseconds of one call of ``fn``: ``reps`` calls captured in
    one CUDA graph and replayed, so that the host's time to issue a call
    (which exceeds a short kernel's) stays out of the number.  The warm-up
    call runs on a side stream, as a capture that holds an autograd backward
    needs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def compare(kernel: str, case: str, out, ref, dtype, ms: float, plain_ms: float,
            calls: int, work: tuple[float, float] | None = None, run: str = "caption",
            tol: float | None = None, library_ms: float = 0.0,
            per_run: bool | None = None) -> None:
    """Hold one kernel output against the plain version's.  ``calls``: how
    often one ``run`` of a main path ("caption": a b8 caption forward,
    "train": a b16 XE training step, "detector": a b4 832x1344 detector
    training step) makes this call (0: a check only); ``work``: (bytes moved
    once each, operations) of the call, for the bound; ``library_ms``: one
    PyTorch call for the same function, where there is one.  ``per_run``:
    whether the times add up to the kernel's per-run numbers (by default the
    bf16 calls do; the fp32 kernels' rows pass True)."""
    if not torch.isfinite(out).all():
        fail(f"{kernel} {case}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    tol = TOL[dtype] if tol is None else tol
    print(f"  {kernel} {case:<30} max_abs {err:.3e} max_rel {rel:.3e} (tol {tol:.0e})  "
          f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)
    if rel > tol:
        fail(f"{kernel} {case}: max rel err {rel:.3e} > {tol:.0e}")
    rec = RESULTS.setdefault(kernel, {"max_abs_err": 0.0, **{
        r: {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": 0.0}
        for r in RUNS}})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    row = {"kernel": kernel, "case": case, "max_abs_err": err, "max_rel_err": rel,
           "tol": tol, "ms": ms, "plain_ms": plain_ms, "calls_per_run": calls, "run": run}
    if work is not None:
        row["bytes_ms"] = work[0] / PEAK_BYTES * 1e3
        row["ops_ms"] = work[1] / PEAK_FLOPS[dtype] * 1e3
    if library_ms:
        row["library_ms"] = library_ms
    DETAIL.append(row)
    if per_run is None:
        per_run = dtype == torch.bfloat16
    if per_run and calls and work is not None:
        # the main path's time in this kernel per run: each shape's median
        # time, and its least possible time, times the calls one run makes at
        # that shape
        acc = rec[run]
        acc["ms"] += ms * calls
        acc["plain_ms"] += plain_ms * calls
        acc["bytes_ms"] += row["bytes_ms"] * calls
        acc["ops_ms"] += row["ops_ms"] * calls
        acc["library_ms"] += library_ms * calls


def esize(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def block_work(rows: int, c: int, heads: int, dtype, maps: int,
               window: int = WINDOW) -> tuple[float, float]:
    """K1 / K4: ``maps`` row-by-C tensors in and out, the four projection
    matrices once; the qkv and proj products and the two attention products."""
    n = window * window
    return ((maps * rows * c + 4 * c * c + 4 * c) * esize(dtype) + (2 * window - 1) ** 2 * heads * 4,
            8.0 * rows * c * c + 4.0 * rows * n * c)


def mlp_work(rows: int, c: int, dtype) -> tuple[float, float]:
    return (2 * rows * c + 8 * c * c + 5 * c) * esize(dtype) + 8 * c, 16.0 * rows * c * c


def msda_touched(value, levels, loc, attn, real_hw) -> int:
    """(image, value row, head) segments that one call's taps read, each
    counted once: the value bytes these inputs need (a valid corner, as the
    kernels and the plain version decide it)."""
    n, s, _ = value.shape
    _, lq, m, _, p, _ = loc.shape
    img = torch.arange(n, device=value.device).view(n, 1, 1, 1)
    head = torch.arange(m, device=value.device).view(1, 1, m, 1)
    keys = []
    for lid, ((h, w), st) in enumerate(zip(levels, msda_ops.level_start_index(levels))):
        hmax = real_hw[:, lid, 0].clamp(max=h).view(n, 1, 1, 1)
        wmax = real_hw[:, lid, 1].clamp(max=w).view(n, 1, 1, 1)
        x0 = torch.floor(loc[:, :, :, lid, :, 0] * w - 0.5).long()
        y0 = torch.floor(loc[:, :, :, lid, :, 1] * h - 0.5).long()
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            ix, iy = x0 + dx, y0 + dy
            valid = (ix >= 0) & (ix < wmax) & (iy >= 0) & (iy < hmax)
            keys.append((((img * s + st + iy * w + ix) * m) + head)[valid])
    return torch.unique(torch.cat(keys)).numel()


def msda_work(args, dtype, backward: bool) -> tuple[float, float]:
    """K3 / K6 on ``args`` (value, levels, locations, weights, real_hw).
    Forward: the value rows the taps read (``msda_touched``), locations and
    weights in, the output out; 4 corners of a multiply-add and the weighting
    per tap and channel.  Backward: also dOut in, the whole value gradient
    and the location and weight gradients out; about three times the
    arithmetic."""
    value, loc = args[0], args[2]
    n, s, c = value.shape
    _, lq, mh, L, p, _ = loc.shape
    taps = L * p
    meta = n * lq * mh * taps * 3 * 4
    nbytes = (msda_touched(*args) * (c // mh) + n * lq * c) * esize(dtype) + meta
    ops = 10.0 * n * lq * c * taps
    if backward:
        nbytes += n * s * c * esize(dtype) + meta
        ops *= 3
    return nbytes, ops


def no_time(fn, reps: int = 0) -> float:
    """The timer of a check that is not timed."""
    return 0.0


def phase_kernels(batch: int, counted: bool = True, stages=None, levels=None,
                  hw=None, preset: str = "") -> None:
    """K1-K3 at the shapes a forward in eval() of ``batch`` images gives
    them: a caption forward at 384x640 or, with ``stages`` / ``levels`` /
    ``hw``, the detector's evaluation at 832x1344.  ``counted``: these are the
    calls of the b8 caption batch whose times add up to the per-run numbers;
    otherwise a comparison only.  ``preset``: the stages are another Swin
    preset's (its window), K1 and K2 checked and not timed, no K3 (the MSDA
    widths do not change with the backbone)."""
    stages, levels, hw = stages or STAGES, levels or MSDA_LEVELS, hw or HW
    print(f"[kernels] kernel vs plain at the {hw[0]}x{hw[1]} main-path shapes, b{batch} "
          f"{preset}", flush=True)
    g = torch.Generator(device=DEV).manual_seed(0)
    tag = ("" if counted else f" b{batch} {hw[0]}x{hw[1]}") + (f" {preset}" if preset else "")
    timer = no_time if preset else cuda_ms
    window = BACKBONES[preset]["window"] if preset else WINDOW

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        for name, c, heads, real, (hp, wp), depth in stages:
            x = torch.zeros(batch, hp, wp, c, device=DEV)
            x[:, :real[0], :real[1]] = rnd(batch, real[0], real[1], c)
            x = x.to(dtype)
            p = dict(norm_w=1 + rnd(c, scale=0.1), norm_b=rnd(c, scale=0.1),
                     qkv_w=rnd(3 * c, c, scale=c ** -0.5).to(dtype),
                     qkv_b=rnd(3 * c, scale=0.02).to(dtype),
                     proj_w=rnd(c, c, scale=c ** -0.5).to(dtype),
                     proj_b=rnd(c, scale=0.02).to(dtype),
                     table=rnd((2 * window - 1) ** 2, heads))
            for shift in (0, window // 2):
                kw = dict(num_heads=heads, window=window, real_hw=real, shift=shift)
                out = wa.block_step(x, **p, **kw)
                ref = wa.block_step_plain(x, **p, **kw)
                # outputs at window-padding tokens are unspecified: compare the real map
                compare("K1", f"{dn} {name}{tag} shift={shift}", out[:, :real[0], :real[1]],
                        ref[:, :real[0], :real[1]], dtype,
                        timer(lambda: wa.block_step(x, **p, **kw)),
                        timer(lambda: wa.block_step_plain(x, **p, **kw)),
                        depth // 2 * counted,
                        block_work(batch * hp * wp, c, heads, dtype, 2, window))
            rows = x.reshape(-1, c)
            m = [1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
                 rnd(4 * c, c, scale=c ** -0.5).to(dtype), rnd(4 * c, scale=0.02).to(dtype),
                 rnd(c, 4 * c, scale=(4 * c) ** -0.5).to(dtype), rnd(c, scale=0.02).to(dtype)]
            compare("K2", f"{dn} {name}{tag}", wa.mlp(rows, *m), wa.mlp_plain(rows, *m), dtype,
                    timer(lambda: wa.mlp(rows, *m)), timer(lambda: wa.mlp_plain(rows, *m)),
                    depth * counted, mlp_work(rows.shape[0], c, dtype))
            compare("K2", f"{dn} {name}{tag} residual=False", wa.mlp(rows, *m, residual=False),
                    wa.mlp_plain(rows, *m, residual=False), dtype,
                    timer(lambda: wa.mlp(rows, *m, residual=False)),
                    timer(lambda: wa.mlp_plain(rows, *m, residual=False)), 0)

        if preset:
            continue
        args = msda_inputs(g, batch, levels, dtype)
        compare("K3", f"{dn} {hw[0]}x{hw[1]} pyramid{tag}", msda_ops.msda(*args),
                msda_ops.msda_plain(*args), dtype, graph_ms(lambda: msda_ops.msda(*args)),
                cuda_ms(lambda: msda_ops.msda_plain(*args)), DET_LAYERS * counted,
                msda_work(args, dtype, False))


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


def phase_train_kernels(batch: int, counted: bool = True, stages=None, levels=None,
                        hw=None, n_frozen: int = FROZEN_STAGES - 1, run: str = "train",
                        preset: str = "") -> None:
    """Every kernel at the shapes one training step of ``batch`` images gives
    it: K1 and K2 (with its residual) on the padded map of the frozen stage 1;
    K4, K5 and K2 with ``residual=False`` (on the unpadded rows) at the three
    stages that train; K3 and K6 at the caption pyramid, and at the 832x1344
    detection pyramid.  ``counted``: these are the calls of the b16 XE step
    whose times add up to the per-run numbers, and the detection pyramid is
    checked too; otherwise (the b8 of the SCST update) a comparison only.
    With ``stages`` / ``levels`` / ``hw`` and ``n_frozen=0``, ``run="detector"``:
    the shapes of one detector training step at 832x1344, where every stage
    trains.  ``preset``: the stages are another Swin preset's (its window),
    checked and not timed, no K3 / K6."""
    stages, levels, hw = stages or STAGES, levels or MSDA_LEVELS, hw or HW
    print(f"[kernels] kernels vs plain (autograd for the backwards) at the {hw[0]}x{hw[1]} "
          f"shapes of one training step, b{batch} {preset}", flush=True)
    g = torch.Generator(device=DEV).manual_seed(1)
    window = BACKBONES[preset]["window"] if preset else WINDOW
    n = window * window
    timer = no_time if preset else cuda_ms
    tag = f" {preset}" if preset else ""

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        for k, (name, c, heads, real, (hp, wp), depth) in enumerate(stages):
            frozen = k < n_frozen
            rows = batch * hp * wp
            x = torch.zeros(batch, hp, wp, c, device=DEV)     # zero outside the real map
            x[:, :real[0], :real[1]] = rnd(batch, real[0], real[1], c)
            x = x.to(dtype)
            p = dict(qkv_w=rnd(3 * c, c, scale=c ** -0.5).to(dtype),
                     qkv_b=rnd(3 * c, scale=0.02).to(dtype),
                     proj_w=rnd(c, c, scale=c ** -0.5).to(dtype),
                     proj_b=rnd(c, scale=0.02).to(dtype),
                     table=rnd((2 * window - 1) ** 2, heads))
            m = [1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
                 rnd(4 * c, c, scale=c ** -0.5).to(dtype), rnd(4 * c, scale=0.02).to(dtype),
                 rnd(c, 4 * c, scale=(4 * c) ** -0.5).to(dtype), rnd(c, scale=0.02).to(dtype)]
            # a frozen stage runs K2 over its padded rows with the residual; a stage
            # that trains over its unpadded rows, the branch alone (drop-path is on)
            mrows = (x if frozen else x[:, :real[0], :real[1]]).reshape(-1, c)
            mkw = dict(residual=frozen)
            compare("K2", f"{dn} {name} b{batch}{tag} residual={frozen}",
                    wa.mlp(mrows, *m, **mkw), wa.mlp_plain(mrows, *m, **mkw), dtype,
                    timer(lambda: wa.mlp(mrows, *m, **mkw)),
                    timer(lambda: wa.mlp_plain(mrows, *m, **mkw)), depth * counted,
                    mlp_work(mrows.shape[0], c, dtype), run)
            d_ao = rnd(rows, c).to(dtype)
            for shift in (0, window // 2):
                case = f"{dn} {name} b{batch}{tag} shift={shift}"
                kw = dict(num_heads=heads, window=window, shift=shift)
                if frozen:
                    ln = dict(norm_w=1 + rnd(c, scale=0.1), norm_b=rnd(c, scale=0.1))
                    out = wa.block_step(x, **ln, **p, **kw, real_hw=real)
                    ref = wa.block_step_plain(x, **ln, **p, **kw, real_hw=real)
                    compare("K1", case, out[:, :real[0], :real[1]], ref[:, :real[0], :real[1]],
                            dtype, timer(lambda: wa.block_step(x, **ln, **p, **kw, real_hw=real)),
                            timer(lambda: wa.block_step_plain(x, **ln, **p, **kw, real_hw=real)),
                            depth // 2 * counted, block_work(rows, c, heads, dtype, 2, window),
                            run)
                    continue
                out, ao = wa.block_attention(x, **p, **kw, save_attn=True)
                ref, ref_ao, qkv = wa.block_attention_plain(x, **p, **kw)
                ms = timer(lambda: wa.block_attention(x, **p, **kw, save_attn=True))
                plain_ms = timer(lambda: wa.block_attention_plain(x, **p, **kw))
                compare("K4", case + " branch", out, ref, dtype, ms, plain_ms,
                        depth // 2 * counted, block_work(rows, c, heads, dtype, 3, window), run)
                compare("K4", case + " attn_out", ao, ref_ao, dtype, ms, plain_ms, 0)

                geo = dict(batch=batch, hp=hp, wp=wp, **kw)
                dqkv, dtable = wa.window_attention_bwd(qkv, d_ao, p["table"], **geo)
                ref_dqkv, ref_dtable = wa.window_attention_bwd_plain(qkv, d_ao, p["table"], **geo)
                ms = timer(lambda: wa.window_attention_bwd(qkv, d_ao, p["table"], **geo))
                plain_ms = timer(
                    lambda: wa.window_attention_bwd_plain(qkv, d_ao, p["table"], **geo), reps=3)
                work = ((7 * rows * c) * esize(dtype)
                        + ((hp // window) * (wp // window) * heads * n * n
                           + (2 * window - 1) ** 2 * heads) * 4, 10.0 * rows * n * c)
                for j, part in enumerate(("dq", "dk", "dv")):
                    compare("K5", f"{case} {part}", dqkv[:, j * c:(j + 1) * c],
                            ref_dqkv[:, j * c:(j + 1) * c], dtype, ms, plain_ms,
                            depth // 2 * counted if j == 0 else 0, work if j == 0 else None,
                            run)
                compare("K5", case + " dtable", dtable, ref_dtable, dtype, ms, plain_ms, 0)
                del ref_dqkv, ref_dtable, dqkv, ref, ref_ao, qkv

        if preset:
            continue
        pyramids = [(levels, f"{hw[0]}x{hw[1]} pyramid b{batch}", batch, DET_LAYERS * counted)]
        if counted and run == "train":
            pyramids.append((DET_LEVELS, "832x1344 pyramid", 2, 0))
        for pyramid, tag, nb, calls in pyramids:
            args = msda_inputs(g, nb, pyramid, dtype)
            compare("K3", f"{dn} {tag}", msda_ops.msda(*args), msda_ops.msda_plain(*args),
                    dtype, graph_ms(lambda: msda_ops.msda(*args)),
                    cuda_ms(lambda: msda_ops.msda_plain(*args), reps=3), calls,
                    msda_work(args, dtype, False), run)
            dout = rnd(nb, 150, 512).to(dtype)
            grads = msda_ops.msda_bwd(dout, *args)
            refs = msda_ops.msda_bwd_plain(dout, *args)
            ms = graph_ms(lambda: msda_ops.msda_bwd(dout, *args))
            plain_ms = cuda_ms(lambda: msda_ops.msda_bwd_plain(dout, *args), reps=3)
            work = msda_work(args, dtype, True)
            for j, part in enumerate(("dvalue", "dloc", "dattn")):
                compare("K6", f"{dn} {tag} {part}", grads[j], refs[j], dtype, ms, plain_ms,
                        calls if j == 0 else 0, work if j == 0 else None, run)


def sdpa_bwd_ms(q, k, v, bias, gout, batch: int) -> float:
    """Device ms of one PyTorch call for the window-attention backward, the
    yardstick of K5: the backward of F.scaled_dot_product_attention(q, k, v,
    attn_mask=mask) with the mask requiring grad (dq, dk, dv and the mask's
    gradient), the mask the [nW, heads, N, N] bias broadcast over the batch,
    so that its gradient is summed over images per window as K5's is.  Timed
    as device time (graph_ms) of the forward and backward together, less the
    forward alone; the scatter into the table's rows is not included."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]

    def forward():
        mask = leaves[3].unsqueeze(0).expand(batch, *bias.shape).reshape(-1, *bias.shape[1:])
        return F.scaled_dot_product_attention(*leaves[:3], attn_mask=mask)

    return graph_ms(lambda: torch.autograd.grad(forward(), leaves, gout)) - graph_ms(forward)


def phase_yardsticks(run: str, batch: int, stages, n_frozen: int, preset: str = "") -> None:
    """The kernels that do the work of K1, K2, K4, K5 and K10a at every shape
    at which one ``run`` of a main path launches them ("caption": a b8
    forward in eval(); "train": a b16 XE step, stages < ``n_frozen`` frozen;
    "detector": a b4 832x1344 step, every stage training), each against its
    plain version and beside one PyTorch call for the same function, timed
    and used nowhere in the port: the GEMM (bf16 and fp32) beside F.linear, a
    GEMM launch; the bf16 attention core beside scaled_dot_product_attention
    with an additive mask, a core launch; at the training runs the bf16
    attention backward (K5's launch) beside SDPA's backward with the mask
    requiring grad (``sdpa_bwd_ms``), its bias gradient checked to be the same
    bit for bit over two calls; at the training runs' shapes also the fp32
    core and backward (the type both training CLIs default to) beside SDPA and
    its backward in fp32, the backward's two calls bit-equal too.  Kernel and
    library times are device times (``graph_ms``), the plain versions'
    eager.  ``preset``: the same at another Swin preset's stages (its window
    and last merge), whose times go to the cases and to this phase's own sums
    a run, not to the kernels' per-run numbers."""
    import torch.nn.functional as F

    print(f"[yardsticks] the GEMM, attention core and backward at the {run} run's shapes, "
          f"b{batch} {preset}, beside F.linear, SDPA + mask and its backward", flush=True)
    g = torch.Generator(device=DEV).manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    window, pos_dim = (BACKBONES[preset]["window"], BACKBONES[preset]["pos_dim"]) if preset \
        else (WINDOW, 1024)
    n = window * window
    training = run != "caption"
    counted = not preset
    tag_p = f" {preset}" if preset else ""
    # this phase's own sums a run: (kernel, "ms" / "library_ms" / "bound_ms") -> ms
    sums: dict = collections.defaultdict(float)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    lin = lin32 = sdpa = 0.0
    for k, (name, c, heads, real, (hp, wp), depth) in enumerate(stages):
        frozen = k < n_frozen
        rows_p, rows_u = batch * hp * wp, batch * real[0] * real[1]
        rows_m = batch * ((real[0] + 1) // 2) * ((real[1] + 1) // 2)
        n_out = stages[k + 1][1] if k + 1 < len(stages) else pos_dim
        x = rnd(batch, hp, wp, c).to(bf)
        a_p = x.reshape(-1, c)
        a_k2 = a_p if frozen else rnd(rows_u, c).to(bf)      # K2's rows
        h_k2 = rnd(a_k2.shape[0], 4 * c).to(bf)
        wts = {nm: (rnd(fo, fi, scale=fi ** -0.5).to(bf), rnd(fo, scale=0.02).to(bf))
               for nm, (fo, fi) in (("qkv", (3 * c, c)), ("proj", (c, c)), ("fc1", (4 * c, c)),
                                    ("fc2", (c, 4 * c)))}
        qs = dict(scale=(c // heads) ** -0.5, scale_cols=c)
        launches = []   # (label, calls a run, A, (W, bias), gemm kwargs)
        if frozen:      # K1 and K2 (with its residual) on the padded map
            launches.append(("K1 qkv", depth, a_p, wts["qkv"], qs))
            for shift in (0, window // 2):
                launches.append((f"K1 proj shift={shift}", depth // 2, a_p, wts["proj"],
                                 dict(epilogue="resid_map", resid=x,
                                      geo=(hp, wp, window, shift, *real))))
            launches.append(("K2 fc1", depth, a_k2, wts["fc1"], dict(epilogue="gelu")))
            launches.append(("K2 fc2", depth, h_k2, wts["fc2"], dict(epilogue="resid", resid=a_k2)))
        else:           # K4 on the padded map, K2 without its residual on the real rows
            for shift in (0, window // 2):
                geo = (hp, wp, window, shift, hp, wp)
                launches.append((f"K4 qkv shift={shift}", depth // 2, x, wts["qkv"],
                                 dict(qs, geo=geo, gather=True)))
                launches.append((f"K4 proj shift={shift}", depth // 2, a_p, wts["proj"],
                                 dict(epilogue="map", geo=geo)))
            launches.append(("K2 fc1", depth, a_k2, wts["fc1"], dict(epilogue="gelu")))
            launches.append(("K2 fc2", depth, h_k2, wts["fc2"], {}))
        launches.append((f"K10a -> {n_out}", 1, rnd(rows_m, 4 * c).to(bf),
                         (rnd(n_out, 4 * c, scale=(4 * c) ** -0.5).to(bf), None), {}))
        for label, calls, a, (w, bias), kw in launches:
            m_rows = a.numel() // w.shape[1]
            # A, W and the bias read once, the output written once (the residual read once)
            nbytes = (a.numel() + w.numel() + m_rows * w.shape[0] + w.shape[0]) * 2
            if "resid" in kw:
                nbytes += m_rows * w.shape[0] * 2
            flops = 2.0 * m_rows * w.shape[0] * w.shape[1]
            shape = f"{name} {label} {m_rows}x{w.shape[0]}x{w.shape[1]} b{batch}{tag_p}"
            for dt in (bf, f32):
                a_d, w_d = a.to(dt), w.to(dt)
                b_d = None if bias is None else bias.to(dt)
                kw_d = dict(kw, resid=kw["resid"].to(dt)) if "resid" in kw else kw
                a2 = a_d.reshape(m_rows, w.shape[1])
                lib = graph_ms(lambda: F.linear(a2, w_d, b_d))
                key = "gemm_bf16" if dt == bf else "gemm_f32"
                ms = graph_ms(lambda: wa.gemm(a_d, w_d, b_d, **kw_d))
                compare(key, f"{'bf16' if dt == bf else 'fp32'} {shape}",
                        wa.gemm(a_d, w_d, b_d, **kw_d), wa.gemm_plain(a_d, w_d, b_d, **kw_d), dt,
                        ms, cuda_ms(lambda: wa.gemm_plain(a_d, w_d, b_d, **kw_d), reps=3),
                        calls * counted, (nbytes * esize(dt) // 2, flops), run, library_ms=lib,
                        per_run=True)
                # the products with an N or K tail on the bf16 kernel's 128 x 64 tiles
                tailed = dt == bf and (w.shape[0] % 128 or w.shape[1] % 64)
                for k in (key, "gemm_bf16 tails") if tailed else (key,):
                    sums[k, "ms"] += ms * calls
                    sums[k, "library_ms"] += lib * calls
                    sums[k, "bound_ms"] += calls * max(nbytes * esize(dt) // 2 / PEAK_BYTES,
                                                       flops / PEAK_FLOPS[dt]) * 1e3
                if dt == bf:
                    lin += lib * calls
                else:
                    lin32 += lib * calls
        del launches, x, a_p, a_k2, h_k2
        qkv = rnd(rows_p, 3 * c).to(bf)
        qkv[:, :c] = (qkv[:, :c].float() * (c // heads) ** -0.5).to(bf)
        d_ao = rnd(rows_p, c).to(bf)
        table = rnd((2 * window - 1) ** 2, heads)
        nw = (hp // window) * (wp // window)
        q, kk, v = (rnd(rows_p // n, heads, n, 32).to(bf) for _ in range(3))
        gout = rnd(rows_p // n, heads, n, 32).to(bf)
        mask = rnd(1, heads, n, n).to(bf)
        bias_w = rnd(nw, heads, n, n).to(bf)
        lib = graph_ms(lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=mask))
        lib_bwd = sdpa_bwd_ms(q, kk, v, bias_w, gout, batch) if training else 0.0
        dtypes = (bf, f32) if training else (bf,)
        lib32 = lib32_bwd = 0.0
        if training:
            q32, k32, v32, g32 = (t.float() for t in (q, kk, v, gout))
            lib32 = graph_ms(lambda: F.scaled_dot_product_attention(q32, k32, v32,
                                                                     attn_mask=mask.float()))
            lib32_bwd = sdpa_bwd_ms(q32, k32, v32, bias_w.float(), g32, batch)
        for shift in (0, window // 2):
            kw = dict(batch=batch, hp=hp, wp=wp, num_heads=heads, window=window, shift=shift)
            tag = f"{name} {'K1' if frozen else 'K4'} core shift={shift} b{batch}{tag_p}"
            for dt in dtypes:
                es = esize(dt)
                qkv_d, d_ao_d = qkv.to(dt), d_ao.to(dt)
                work = (rows_p * 4 * c * es + (2 * window - 1) ** 2 * heads * 4,
                        4.0 * rows_p * n * c)
                key = "win_attn" if dt == bf else "win_attn_f32"
                ms = graph_ms(lambda: wa.attention_core(qkv_d, table, **kw))
                compare(key, f"{'bf16' if dt == bf else 'fp32'} {tag}",
                        wa.attention_core(qkv_d, table, **kw),
                        wa.attention_core_plain(qkv_d, table, **kw), dt, ms,
                        cuda_ms(lambda: wa.attention_core_plain(qkv_d, table, **kw), reps=3),
                        depth // 2 * counted, work, run, library_ms=lib if dt == bf else lib32,
                        per_run=True)
                sums[key, "ms"] += ms * (depth // 2)
                sums[key, "library_ms"] += (lib if dt == bf else lib32) * (depth // 2)
                sums[key, "bound_ms"] += (depth // 2) * max(work[0] / PEAK_BYTES,
                                                            work[1] / PEAK_FLOPS[dt]) * 1e3
                if dt == bf:
                    sdpa += lib * (depth // 2)
                if frozen:
                    continue
                # K5: one launch of the backward (its wrapper: the kernel, the sum of the
                # partial bias gradient and its scatter into the table)
                out = wa.window_attention_bwd(qkv_d, d_ao_d, table, **kw)
                again = wa.window_attention_bwd(qkv_d, d_ao_d, table, **kw)
                if not torch.equal(out[1], again[1]) or not torch.equal(out[0], again[0]):
                    fail(f"K5 {tag} {dt}: two calls on the same inputs differ")
                ref = wa.window_attention_bwd_plain(qkv_d, d_ao_d, table, **kw)
                bwd = "win_attn_bwd" if dt == bf else "win_attn_bwd_f32"
                work = (7 * rows_p * c * es + (nw * heads * n * n + (2 * window - 1) ** 2 * heads)
                        * 4, 10.0 * rows_p * n * c)
                ms = graph_ms(lambda: wa.window_attention_bwd(qkv_d, d_ao_d, table, **kw))
                lib_b = lib_bwd if dt == bf else lib32_bwd
                compare(bwd, f"{'bf16' if dt == bf else 'fp32'} {tag} backward dqkv", out[0],
                        ref[0], dt, ms,
                        cuda_ms(lambda: wa.window_attention_bwd_plain(qkv_d, d_ao_d, table, **kw),
                                reps=3),
                        depth // 2 * counted, work, run, library_ms=lib_b, per_run=True)
                sums[bwd, "ms"] += ms * (depth // 2)
                sums[bwd, "library_ms"] += lib_b * (depth // 2)
                sums[bwd, "bound_ms"] += (depth // 2) * max(work[0] / PEAK_BYTES,
                                                            work[1] / PEAK_FLOPS[dt]) * 1e3
                compare(bwd, f"{'bf16' if dt == bf else 'fp32'} {tag} backward dtable", out[1],
                        ref[1], dt, 0.0, 0.0, 0)
                del out, again, ref
        del qkv, d_ao, q, kk, v, gout, bias_w
    if preset:
        # a run of the preset's path: each kernel's time, its library call's and
        # its bound, summed over the launches at these shapes
        totals = {f"{k} {what}": v for (k, what), v in sorted(sums.items())}
        YARDSTICKS[f"{run} {preset}"] = {"batch": batch, **totals}
        print(f"[yardsticks] {run} {preset} b{batch}, a run: " + ", ".join(
            f"{k} {sums[k, 'ms']:.3f} ms (library {sums[k, 'library_ms']:.3f}, bound "
            f"{sums[k, 'bound_ms']:.3f})" for k in sorted({k for k, _ in sums})), flush=True)
        return
    YARDSTICKS[run] = {"linear_ms": lin, "linear_f32_ms": lin32, "sdpa_ms": sdpa, "batch": batch}
    msg = (f"[yardsticks] {run}: bf16 GEMM {RESULTS['gemm_bf16'][run]['ms']:.3f} ms a run "
           f"(F.linear {lin:.3f}), fp32 GEMM {RESULTS['gemm_f32'][run]['ms']:.3f} ms "
           f"(F.linear fp32 {lin32:.3f}, bound "
           f"{max(RESULTS['gemm_f32'][run]['bytes_ms'], RESULTS['gemm_f32'][run]['ops_ms']):.3f}), "
           f"attention core {RESULTS['win_attn'][run]['ms']:.3f} ms (SDPA + mask {sdpa:.3f})")
    if training:
        r = RESULTS["win_attn_bwd"][run]
        msg += (f", bf16 attention backward {r['ms']:.3f} ms (SDPA backward {r['library_ms']:.3f}, "
                f"bound {max(r['bytes_ms'], r['ops_ms']):.3f})")
    if training:
        for key in ("win_attn_f32", "win_attn_bwd_f32"):
            r = RESULTS[key][run]
            msg += (f"; {key} {r['ms']:.3f} ms (library {r['library_ms']:.3f}, bound "
                    f"{max(r['bytes_ms'], r['ops_ms']):.3f})")
    print(msg, flush=True)


# the caption generator's decode layer at full width, and the decode shapes
# of the caption paths: 60 grid tokens and 150 regions at 384x640
D_MODEL, N_HEADS, D_FF, T_GRID, T_REG = 512, 8, 2048, 60, 150
ADAM_TOL = 1e-6   # same f32 operations in the same order; sqrt and division to an ulp


def count_launches(fn) -> int:
    """Device kernels launched by one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and getattr(e, "self_device_time_total", 0) > 0)


def graph_launches(fn) -> int:
    """Kernel launches of one call of ``fn``: the kernel nodes of a CUDA graph
    that captures it (read through the CUDA runtime), which needs no
    profiler.  The warm-up call runs on a side stream, as in ``graph_ms``."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        fail("graph_launches: cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n))
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kernels += kind.value == 0   # cudaGraphNodeTypeKernel
    del graph
    return kernels


def kernel_name(key: str) -> str:
    """A profiler key's kernel function name (``dt_qproj_kernel``), its
    template arguments and parameters dropped."""
    import re

    m = re.search(r"(\w+)(?:<|\()", key.split("::")[-1])
    return m.group(1) if m else key[:60]


def launch_times(fn, calls: int = 10, name_of=kernel_name) -> dict[str, tuple[float, float]]:
    """{name: (device ms a call, launches a call)} of the kernels one call of
    ``fn`` launches (torch.profiler over ``calls`` calls), summed by
    ``name_of(profiler key)``: by default the kernel's function name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, list[float]] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            acc = out.setdefault(name_of(e.key), [0.0, 0.0])
            acc[0] += us / 1e3 / calls
            acc[1] += e.count / calls
    return {k: (v[0], v[1]) for k, v in out.items()}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def phase_decode_kernel() -> None:
    """K11 against its plain version at the decode shapes of a b8 and a b128
    caption batch (40 and 640 rows, beam 5) and of the trainer's b16
    evaluation batch (80 rows: two row tiles; weights cast from f32 master
    parameters at the call, as a model built for training hands them over),
    with and without key masks, half the rows pad, on a decode layer's own
    weights; beside it the module path for the same tail (no single PyTorch
    call computes it), timed and its launches counted.  The kernel's and the
    module path's times are device times by CUDA-graph replay (``graph_ms``;
    their eager times by CUDA events beside them), the plain version's eager.
    Each case must give the same output bit for bit from two calls, make
    exactly 8 CUDA launches a call (``graph_launches``) and count one
    ``decode_tail`` launch; at b8 the device time of each of the eight
    launches is printed."""
    print("[kernels] K11 (decode-layer tail) vs plain, beam-5 rows over 60 + 150 keys",
          flush=True)
    g = torch.Generator(device=DEV).manual_seed(3)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        layer = cap_generator_lib.ParallelAttentionLayer(D_MODEL, N_HEADS, D_FF).to(DEV).eval()
        with torch.no_grad():
            for name, prm in layer.named_parameters():
                if "layer_norm" in name:
                    prm.copy_((name.endswith("weight")) + rnd(*prm.shape, scale=0.1))
                elif prm.dim() == 2:
                    prm.copy_(rnd(*prm.shape, scale=prm.shape[1] ** -0.5))
                else:
                    prm.copy_(rnd(*prm.shape, scale=0.02))
        from_masters = layer.tail_weights(dtype)
        to_compute_dtype(layer, dtype)
        stored = layer.tail_weights(dtype)
        wbytes = sum(w.numel() for w in stored) * esize(dtype)
        for batch in (8, EVAL_BATCH, 128):
            weights = from_masters if batch == EVAL_BATCH else stored
            rows = batch * BEAM
            x = rnd(rows, 1, D_MODEL).to(dtype)
            kv = [rnd(batch, t, D_MODEL).to(dtype) for t in (T_GRID, T_GRID, T_REG, T_REG)]
            pad = (torch.arange(rows, device=DEV) % 2 == 0).to(dtype)[:, None, None]
            for masked in (True, False):
                masks = [None, None]
                if masked:   # odd images hide the last quarter of their keys
                    masks = [(torch.arange(t, device=DEV)[None] >= t * 3 // 4)
                             & (torch.arange(batch, device=DEV)[:, None] % 2 == 1)
                             for t in (T_GRID, T_REG)]
                    masks = [m[:, None, None, :].contiguous() for m in masks]
                kw = dict(fold=BEAM, n_heads=N_HEADS, eps=1e-5)

                def kernel():
                    return tail_ops.fused_decode_layer_tail(
                        x, kv[0], kv[1], masks[0], kv[2], kv[3], masks[1], pad, weights, **kw)

                def plain():
                    madd = [tail_ops.additive_mask(m, batch, t, DEV)
                            for m, t in zip(masks, (T_GRID, T_REG))]
                    return tail_ops.decode_layer_tail_plain(
                        x[:, 0], kv[0], kv[1], madd[0], kv[2], kv[3], madd[1],
                        pad.float().reshape(rows, 1), weights, **kw)

                def module_path():
                    enc1 = layer.vis_att1(x, kv[0], kv[1], masks[0], kv_projected=True,
                                          kv_fold=BEAM) * pad
                    enc2 = layer.vis_att2(x, kv[2], kv[3], masks[1], kv_projected=True,
                                          kv_fold=BEAM) * pad
                    return layer._fuse(x, enc1, enc2, pad)

                case = f"{dn} b{batch} masks={masked}"
                with torch.no_grad():
                    out, ref = kernel()[:, 0], plain()
                    again = kernel()[:, 0]
                    mod = module_path()[:, 0]
                    eager_ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
                    ms = graph_ms(kernel)
                    mod_ms, mod_dev_ms = cuda_ms(module_path), graph_ms(module_path)
                    mod_launches = count_launches(module_path)
                    counted = tail_ops.LAUNCHES["decode_tail"]
                    kernel()
                    counted = tail_ops.LAUNCHES["decode_tail"] - counted
                    own_launches = graph_launches(kernel)
                    per_launch = launch_times(kernel) if batch == 8 and masked else None
                if not bits_equal(out, again):
                    fail(f"K11 {case}: two calls on the same inputs differ")
                if own_launches != 8 or counted != 1:
                    fail(f"K11 {case}: a call made {own_launches} CUDA launches and counted "
                         f"{counted} (want 8 and 1)")
                # the path the caption batch takes: b8, bf16, masks from the padded images
                calls = 3 * STEPS if (batch == 8 and masked) else 0
                work = ((2 * rows * D_MODEL + 2 * batch * (T_GRID + T_REG) * D_MODEL)
                        * esize(dtype) + wbytes,
                        2.0 * rows * (8 * D_MODEL * D_MODEL + 2 * D_MODEL * D_FF)
                        + 4.0 * rows * D_MODEL * (T_GRID + T_REG))
                compare("K11", case, out, ref, dtype, ms, plain_ms, calls, work)
                mod_rel = max_rel(mod.float(), ref.float())
                print(f"  K11 {case:<30} eager {eager_ms:.3f} ms; module path: {mod_dev_ms:.3f} ms "
                      f"device, {mod_ms:.3f} ms eager in {mod_launches} launches (kernel: "
                      f"{own_launches}); module path vs plain {mod_rel:.3e}; two calls bit-equal",
                      flush=True)
                DETAIL[-1].update(eager_ms=eager_ms, module_ms=mod_ms, module_device_ms=mod_dev_ms,
                                  module_launches=mod_launches, wrapper_launches=own_launches,
                                  module_vs_plain=mod_rel, bit_equal=True)
                if per_launch is not None:
                    DETAIL[-1]["launch_ms"] = per_launch
                    print(f"  K11 {case:<30} device ms a call by launch: " + ", ".join(
                        f"{k} {v[0]:.4f} ({v[1]:g}x)" for k, v in per_launch.items())
                        + f"; sum {sum(v[0] for v in per_launch.values()):.4f}", flush=True)
                if mod_rel > TOL[dtype]:
                    fail(f"K11 {case}: module path differs from the plain version by {mod_rel:.3e}")
                if calls and dtype == torch.bfloat16:
                    YARDSTICKS.update({"decode_tail_module_ms": mod_ms,
                                       "decode_tail_module_device_ms": mod_dev_ms,
                                       "decode_tail_module_launches": mod_launches,
                                       "decode_tail_wrapper_launches": own_launches})


def half_layer(layer):
    """Rank 0's tensor-parallel half of a parallel decoder layer, as
    ``parallel.mesh.shard_model`` slices it: a layer of d_ff / 2 whose fc1
    holds the first columns (and bias) and fc2 the first rows."""
    half = cap_generator_lib.ParallelAttentionLayer(
        D_MODEL, N_HEADS, layer.pwff.fc1.out_features // 2).to(DEV).eval()
    state = dict(layer.state_dict())
    state["pwff.fc1.weight"] = state["pwff.fc1.weight"].chunk(2, 0)[0]
    state["pwff.fc1.bias"] = state["pwff.fc1.bias"].chunk(2)[0]
    state["pwff.fc2.weight"] = state["pwff.fc2.weight"].chunk(2, 1)[0]
    half.load_state_dict(state)
    return half


def phase_moe_experts(card: str) -> None:
    """Phase 20: ``ops.moe.routed_experts`` at the Kimi-VL-A3B cell's decode
    and prefill shapes against ``grouped_plain`` on the same bf16 inputs
    (f32 products), and a tiny ``mla_moe`` captioner through
    ``make_caption_generator`` (see the module docstring)."""
    import re

    from gritbench import harness
    from grit_tpu_torch.ops import moe as moe_ops

    pattern = harness.load_module(harness.ROOT / "metrics" / "moe_roofline.caption.py",
                                  "chip_smoke_moe_roofline").KERNEL
    e, d, i, k, tol = 64, 2048, 1408, 6, 1e-2
    g = torch.Generator(device=DEV).manual_seed(24)
    w13 = (torch.randn(e, 2 * i, d, generator=g, device=DEV) * 0.02).bfloat16()
    w2 = (torch.randn(e, d, i, generator=g, device=DEV) * 0.02).bfloat16()
    bias = (torch.rand(e, generator=g, device=DEV) - 0.5) * 0.1
    out = {}
    for label, rows in (("decode", 640), ("prefill", 128 * 211)):
        x = torch.randn(rows, d, generator=g, device=DEV).bfloat16()
        scores = torch.sigmoid(torch.randn(rows, e, generator=g, device=DEV))
        idx = torch.topk(scores + bias, k, dim=-1).indices
        w = scores.gather(1, idx)
        w = w / w.sum(1, keepdim=True) * 2.446
        before = dict(moe_ops.LAUNCHES)
        got = moe_ops.routed_experts(x, idx, w, w13, w2)
        calls = {n: moe_ops.LAUNCHES[n] - before[n] for n in before}
        if calls != {"moe_gate_up": 1, "moe_down": 1}:
            fail(f"moe {label}: grouped GEMM calls {calls}, want one of each")
        if not bits_equal(got, moe_ops.routed_experts(x, idx, w, w13, w2)):
            fail(f"moe {label}: two calls differ")
        order, srows, counts, offs = moe_ops.sort_by_expert(idx, e)
        gu = moe_ops.grouped_plain(x[srows].float(), w13, offs)
        h = torch.nn.functional.silu(gu[:, :i]) * gu[:, i:]
        y = moe_ops.grouped_plain(h, w2, offs)
        ref = got.new_empty(rows * k, d)
        ref[order] = y * w.reshape(-1)[order, None]
        ref = ref.view(rows, k, d).sum(1)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        if not err <= tol:
            fail(f"moe {label}: max rel err {err:.3e} > {tol:.0e}")
        xs = x[srows]
        hb = h.bfloat16()
        names = launch_times(lambda: (moe_ops.grouped_mm(xs, w13, offs, "moe_gate_up"),
                                      moe_ops.grouped_mm(hb, w2, offs, "moe_down")),
                             calls=3, name_of=lambda key: key)
        gemms = {n: v for n, v in names.items() if re.search(pattern, n)}
        if sum(c for _, c in gemms.values()) != 2:
            fail(f"moe {label}: {pattern!r} matches {gemms} of the kernels {sorted(names)}")
        gate_up_ms = cuda_ms(lambda: moe_ops.grouped_mm(xs, w13, offs, "moe_gate_up"))
        down_ms = cuda_ms(lambda: moe_ops.grouped_mm(hb, w2, offs, "moe_down"))
        routed_ms = cuda_ms(lambda: moe_ops.routed_experts(x, idx, w, w13, w2))
        plain_ms = cuda_ms(lambda: (moe_ops.grouped_plain(xs, w13, offs),
                                    moe_ops.grouped_plain(hb, w2, offs)), reps=3)
        slots, hit = rows * k, int((counts > 0).sum())
        bound = {"gate_up": max(2.0 * slots * d * 2 * i / PEAK_FLOPS[torch.bfloat16],
                                2.0 * (hit * 2 * i * d + slots * d + slots * 2 * i) / PEAK_BYTES),
                 "down": max(2.0 * slots * i * d / PEAK_FLOPS[torch.bfloat16],
                             2.0 * (hit * d * i + slots * i + slots * d) / PEAK_BYTES)}
        bound = {n: v * 1e3 for n, v in bound.items()}
        out[label] = {"rows": rows, "slots": slots, "max_rel_err": err, "gate_up_ms": gate_up_ms,
                      "down_ms": down_ms, "routed_ms": routed_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "kernels": {n: v for n, v in names.items()}}
        print(f"[moe] {label} ({rows} rows x {k}): gate+up {gate_up_ms:.3f} ms (bound "
              f"{bound['gate_up']:.3f}), down {down_ms:.3f} ms (bound {bound['down']:.3f}), "
              f"the routed path {routed_ms:.3f} ms, the loop {plain_ms:.2f} ms; err {err:.1e}, "
              f"bit-equal; grouped GEMM kernels {sorted(gemms)}  [{card}]", flush=True)
        del x, scores, idx, w, got, gu, h, y, ref, xs, hb
    torch.cuda.empty_cache()

    RESULTS["moe_experts"] = out
    out["tiny_captioner"] = moe_tiny_captioner(DEV)
    calls = out["tiny_captioner"]["calls"]
    print(f"[moe] tiny mla_moe captioner, bf16, beam 3 x 5: {calls} grouped GEMM calls over "
          f"{out['tiny_captioner']['moe_layers']} MoE layers  [{card}]", flush=True)


def moe_tiny_captioner(device) -> dict:
    """The benchmark's tiny ``mla_moe`` captioner (``gritbench/tests/
    tiny_lm.py``) in bf16 on ``device`` through ``make_caption_generator``,
    from the cached detector features of its float32 twin on the CPU (its
    Swin's head dim of 8 is below what the card's Swin kernels take): the
    grouped GEMM calls counted from 0, one of each product a MoE layer in
    the prefill and in each decode step."""
    from gritbench import inputs, lm_weights
    from gritbench.tests.tiny_lm import LM_CONFIG, LM_TRAFFIC
    from gritbench.traffic.caption_generate_lm import port_config
    from grit_tpu_torch.ops import moe as moe_ops

    m = LM_CONFIG["model"]
    models = {}
    for name, place, dtype in (("f32", "cpu", torch.float32), ("card", device, torch.bfloat16)):
        model = build_captioner(port_config(LM_CONFIG), device=place, dtype=dtype, seed=None)
        shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        lm_weights.load(model, shapes, 11, place, det=m["detector"])
        models[name] = model.eval()
    imgs, pad = inputs.images(LM_TRAFFIC, inputs.generator(11, 17, "cpu"), "cpu")
    with torch.no_grad():
        features = models["f32"].detector(ImageBatch(imgs, pad))
    generate = make_caption_generator(models["card"], beam_size=3, max_len=5,
                                      bos_idx=m["bos_idx"], eos_idx=m["eos_idx"])
    n_moe = sum(1 for n, _ in shapes if n.endswith(".mlp.w13"))
    steps = []
    decode = models["card"].decode_step

    def counted_step(token, t, *a, **k):
        steps.append(t)
        return decode(token, t, *a, **k)

    models["card"].decode_step = counted_step
    for key in moe_ops.LAUNCHES:
        moe_ops.LAUNCHES[key] = 0
    tokens = generate(features, imgs.shape[0])
    calls = dict(moe_ops.LAUNCHES)
    layer_calls = 1 + sum(1 for t in steps if t > 0)
    if calls != {"moe_gate_up": n_moe * layer_calls, "moe_down": n_moe * layer_calls}:
        fail(f"moe: the tiny mla_moe captioner made {calls} grouped GEMM calls, want "
             f"{n_moe} MoE layers x (the prefill + {layer_calls - 1} decode steps) of each")
    return {"calls": calls, "moe_layers": n_moe, "decode_steps": layer_calls - 1,
            "tokens": list(tokens.shape)}


def phase_tp_kernels() -> None:
    """The kernels of the tensor-parallel layout against their plain
    versions.  K11's split (csrc/decode_layer.cu: the partial mode of
    grit_decode_tail and grit_decode_tail_finish) at the decode shapes of a
    b8, b16 and b128 caption batch (40, 80 and 640 rows, beam 5, key masks,
    half the rows pad) on one tp2 rank's half of d_ff (F = 1024), fp32 and
    bf16: the partial entry's part and enc, the finish entry on the partial's
    own part and enc (one rank's sum); two calls bit-equal; one split call
    makes exactly 7 + 1 CUDA launches (``graph_launches``) and counts one
    ``decode_tail_partial`` and one ``decode_tail_finish``.  Timed by graph
    replay, the plain versions eagerly; the b8 bf16 calls are the tp2 caption
    batch's (60 of each a rank).  Then K2 on a rank's half of each Swin-B
    stage's hidden units (256-2048) without fc2's bias, the partial of a tp2
    rank, at the b8 caption rows against ``mlp_plain`` (checks, not timed into
    K2's run)."""
    print("[kernels] K11 split (partial + finish) vs plain, one tp2 rank's half of d_ff",
          flush=True)
    g = torch.Generator(device=DEV).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    eps = 1e-5
    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        layer = cap_generator_lib.ParallelAttentionLayer(D_MODEL, N_HEADS, D_FF).to(DEV).eval()
        with torch.no_grad():
            for name, prm in layer.named_parameters():
                if "layer_norm" in name:
                    prm.copy_((name.endswith("weight")) + rnd(*prm.shape, scale=0.1))
                elif prm.dim() == 2:
                    prm.copy_(rnd(*prm.shape, scale=prm.shape[1] ** -0.5))
                else:
                    prm.copy_(rnd(*prm.shape, scale=0.02))
        half = half_layer(layer)
        to_compute_dtype(half, dtype)
        weights = half.tail_weights(dtype)
        wbytes = sum(w.numel() for w in weights) * esize(dtype)
        for batch in (8, EVAL_BATCH, 128):
            rows = batch * BEAM
            x = rnd(rows, 1, D_MODEL).to(dtype)
            kv = [rnd(batch, t, D_MODEL).to(dtype) for t in (T_GRID, T_GRID, T_REG, T_REG)]
            pad = (torch.arange(rows, device=DEV) % 2 == 0).to(dtype)[:, None, None]
            masks = [((torch.arange(t, device=DEV)[None] >= t * 3 // 4)
                      & (torch.arange(batch, device=DEV)[:, None] % 2 == 1))[:, None, None, :]
                     .contiguous() for t in (T_GRID, T_REG)]
            kw = dict(fold=BEAM, n_heads=N_HEADS, eps=eps)
            padf = pad.float().reshape(rows, 1)
            madd = [tail_ops.additive_mask(m, batch, t, DEV)
                    for m, t in zip(masks, (T_GRID, T_REG))]

            def partial():
                return tail_ops.decode_tail_partial(x, kv[0], kv[1], masks[0], kv[2], kv[3],
                                                    masks[1], pad, weights, **kw)

            def partial_plain():
                return tail_ops.decode_layer_tail_partial_plain(
                    x[:, 0], kv[0], kv[1], madd[0], kv[2], kv[3], madd[1], padf, weights, **kw)

            case = f"{dn} b{batch} tp2 half"
            with torch.no_grad():
                part, enc = partial()
                part2, enc2 = partial()
                part_p, enc_p = partial_plain()

                def finish():
                    return tail_ops.decode_tail_finish(part, enc, *weights[21:], pad, eps=eps)

                def finish_plain():
                    return tail_ops.decode_layer_tail_finish_plain(part, enc, *weights[21:], padf,
                                                                   eps=eps, dtype=dtype)

                out, again, out_p = finish(), finish(), finish_plain()
                counted = dict(tail_ops.LAUNCHES)
                partial()
                finish()
                counted = {k: tail_ops.LAUNCHES[k] - counted[k] for k in counted}
                launches = (graph_launches(partial), graph_launches(finish))
                ms_p, ms_f = graph_ms(partial), graph_ms(finish)
                plain_p, plain_f = cuda_ms(partial_plain), cuda_ms(finish_plain)
            if not (bits_equal(part, part2) and bits_equal(enc, enc2) and bits_equal(out, again)):
                fail(f"K11 split {case}: two calls on the same inputs differ")
            if launches != (7, 1) or counted != {"decode_tail": 0, "decode_tail_partial": 1,
                                                  "decode_tail_finish": 1}:
                fail(f"K11 split {case}: a call made {launches} CUDA launches and counted "
                     f"{counted} (want 7 + 1, one of each)")
            calls = 3 * STEPS if batch == 8 else 0
            f_half = D_FF // 2
            work_p = ((rows * D_MODEL + 2 * batch * (T_GRID + T_REG) * D_MODEL) * esize(dtype)
                      + wbytes + 2 * rows * D_MODEL * 4,
                      2.0 * rows * (8 * D_MODEL * D_MODEL + 2 * D_MODEL * f_half)
                      + 4.0 * rows * D_MODEL * (T_GRID + T_REG))
            work_f = (2 * rows * D_MODEL * 4 + (rows * D_MODEL + rows + D_MODEL) * esize(dtype)
                      + 8 * D_MODEL, 10.0 * rows * D_MODEL)
            compare("K11 partial", case, part, part_p, dtype, ms_p, plain_p, calls, work_p)
            DETAIL[-1].update(wrapper_launches=launches[0], bit_equal=True)
            compare("K11 partial", case + " enc", enc, enc_p, dtype, 0.0, 0.0, 0)
            compare("K11 finish", case, out, out_p, dtype, ms_f, plain_f, calls, work_f)
            DETAIL[-1].update(wrapper_launches=launches[1], bit_equal=True)
    print("[kernels] K2 on one tp2 rank's half of the hidden units (fc2 without its bias) vs "
          "plain, Swin-B at the b8 caption rows", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        for name, c, _, _, (hp, wp), _ in STAGES:
            rows = 8 * hp * wp
            hid = 2 * c          # half of 4C
            x = rnd(rows, c).to(dtype)
            nw, nb = 1 + rnd(c, scale=0.1), rnd(c, scale=0.1)
            w1, b1 = rnd(hid, c, scale=c ** -0.5).to(dtype), rnd(hid, scale=0.02).to(dtype)
            w2 = rnd(c, hid, scale=hid ** -0.5).to(dtype)
            with torch.no_grad():
                out = wa.mlp(x, nw, nb, w1, b1, w2, None, residual=False)
                ref = wa.mlp_plain(x, nw, nb, w1, b1, w2, None, residual=False)
                ms = graph_ms(lambda: wa.mlp(x, nw, nb, w1, b1, w2, None, residual=False))
                plain_ms = cuda_ms(lambda: wa.mlp_plain(x, nw, nb, w1, b1, w2, None,
                                                        residual=False))
            compare("K2", f"{dn} {name} tp2 half (hidden {hid})", out, ref, dtype, ms, plain_ms, 0)


# phase_msda_kernels' cases: (name, batch, pyramid, K6 too); the b128 caption
# batch runs no backward
MSDA_CASES = (("b8 caption", 8, MSDA_LEVELS, True), ("b128 caption", 128, MSDA_LEVELS, False),
              ("b16 XE", TRAIN_BATCH, MSDA_LEVELS, True),
              ("b4 detector", DET_BATCH, DET_LEVELS, True))
# launches a call of the MSDA kernels before their Hopper redesign, counted
# from a captured graph: the weights' cast in bf16, and in K6 the value
# gradient's zero-fill and, in bf16, its cast and the weight gradient's; a
# call may make no more
MSDA_LAUNCHES = {("K3", torch.float32): 1, ("K3", torch.bfloat16): 2,
                 ("K6", torch.float32): 2, ("K6", torch.bfloat16): 5}


def msda_part(key: str) -> str:
    """A profiler key of one K3 / K6 call -> the part of the call it is."""
    if "msda" in key:
        return "kernel"
    if "FillFunctor" in key:
        return "zero-fill"
    return "casts"   # the weights in, the value and weight gradients out


def phase_msda_kernels() -> None:
    """K3 and K6 against their plain versions at the shapes of a b8 and a
    b128 caption forward, a b16 XE step and a b4 832x1344 detector step
    (K6 at all but b128), in fp32 and bf16, on inputs as the deformable
    layer hands them over (weights in the compute type, real_hw int32):
    device ms a call by CUDA-graph replay beside the eager ms, kernel
    launches a call from a captured graph, K6's call split by launch into
    zero-fill, kernel and casts; the bound counts the value rows the taps
    read (``msda_touched``), beside the whole map's.  Fails unless K3's
    output and K6's dloc and dattn are the same bit for bit over two calls
    (dvalue, scattered with atomics, is reported) and a call makes no more
    launches than ``MSDA_LAUNCHES``."""
    print("[kernels] K3 / K6 (MSDA forward / backward) vs plain, device ms by graph replay",
          flush=True)
    g = torch.Generator(device=DEV).manual_seed(4)
    rows = RESULTS.setdefault("msda_phase", {})
    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        for name, batch, levels, backward in MSDA_CASES:
            value, _, loc, attn, real_hw = msda_inputs(g, batch, levels, dtype)
            args = (value, levels, loc, attn.to(dtype), real_hw.to(torch.int32))
            case = f"{dn} {name}"
            map_ms = value.numel() * esize(dtype) / PEAK_BYTES * 1e3

            def fwd():
                return msda_ops.msda(*args)

            with torch.no_grad():
                out, again = fwd(), fwd()
                ref = msda_ops.msda_plain(*args)
                ms, eager_ms = graph_ms(fwd), cuda_ms(fwd)
                plain_ms = cuda_ms(lambda: msda_ops.msda_plain(*args), reps=3)
                launches = graph_launches(fwd)
            if not bits_equal(out, again):
                fail(f"K3 {case}: two calls on the same inputs differ")
            if launches > MSDA_LAUNCHES["K3", dtype]:
                fail(f"K3 {case}: {launches} launches a call (at most "
                     f"{MSDA_LAUNCHES['K3', dtype]})")
            work = msda_work(args, dtype, False)
            compare("K3", f"{case} (msda phase)", out, ref, dtype, ms, plain_ms, 0, work)
            bound = max(work[0] / PEAK_BYTES, work[1] / PEAK_FLOPS[dtype]) * 1e3
            rows[f"K3 {case}"] = row = dict(graph_ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                                            bound_ms=bound, map_bound_ms=map_ms,
                                            graph_launches=launches,
                                            max_rel_err=DETAIL[-1]["max_rel_err"])
            DETAIL[-1].update(row, bit_equal=True)
            print(f"  K3 {case:<30} {ms:.4f} ms device ({eager_ms:.4f} eager), bound "
                  f"{bound:.4f} (the whole map once: {map_ms:.4f}), {launches} launches a call; "
                  "two calls bit-equal", flush=True)
            del out, again, ref
            if not backward:
                continue
            dout = torch.randn(batch, 150, 512, generator=g, device=DEV).to(dtype)

            def bwd():
                return msda_ops.msda_bwd(dout, *args)

            grads, again = bwd(), bwd()
            refs = msda_ops.msda_bwd_plain(dout, *args)
            ms, eager_ms = graph_ms(bwd), cuda_ms(bwd)
            plain_ms = cuda_ms(lambda: msda_ops.msda_bwd_plain(dout, *args), reps=3)
            launches = graph_launches(bwd)
            split = launch_times(bwd, calls=5, name_of=msda_part)
            same = [bits_equal(a, b) for a, b in zip(grads, again)]
            if not (same[1] and same[2]):
                fail(f"K6 {case}: two calls give different dloc / dattn")
            if launches > MSDA_LAUNCHES["K6", dtype]:
                fail(f"K6 {case}: {launches} launches a call (at most "
                     f"{MSDA_LAUNCHES['K6', dtype]})")
            work = msda_work(args, dtype, True)
            bound = max(work[0] / PEAK_BYTES, work[1] / PEAK_FLOPS[dtype]) * 1e3
            for j, part in enumerate(("dvalue", "dloc", "dattn")):
                compare("K6", f"{case} {part} (msda phase)", grads[j], refs[j], dtype, ms,
                        plain_ms, 0, work if j == 0 else None)
            rows[f"K6 {case}"] = row = dict(
                graph_ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound,
                graph_launches=launches, split_ms={k: v[0] for k, v in split.items()},
                split_launches={k: v[1] for k, v in split.items()},
                dvalue_bit_equal=same[0],
                max_rel_err=max(c["max_rel_err"] for c in DETAIL[-3:]))
            DETAIL[-3].update(row, bit_equal_dloc_dattn=True)
            print(f"  K6 {case:<30} {ms:.4f} ms device ({eager_ms:.4f} eager), bound "
                  f"{bound:.4f}, {launches} launches a call: " + ", ".join(
                      f"{k} {v[0]:.4f} ({v[1]:g}x)" for k, v in split.items())
                  + f"; dloc, dattn bit-equal over two calls, dvalue {same[0]}", flush=True)
            del grads, again, refs


def phase_adam_kernel() -> None:
    """K12 against its plain version for 3 consecutive steps on the
    captioner's own trainable leaves under frozen_stages=2 (both groups, plus
    a 1-element and an odd-sized leaf), with and without weight decay (a decay
    large enough that three steps of it move either group's parameters by
    over ten times the tolerance); then the times of one update over the
    model's own leaves: kernel, plain, and torch.optim.Adam(fused=True) as the
    library yardstick."""
    config = default_caption_config()
    config.model.frozen_stages = FROZEN_STAGES
    model = build_captioner(config, device=DEV, seed=0, train=True)
    freeze = optim_lib.frozen_mask(model, optim_lib.swin_frozen_stages_predicate(FROZEN_STAGES))
    opt = optim_lib.build_optimizer(model, model_lr=1e-4, backbone_lr=1e-5, freeze=freeze)
    shapes = [[tuple(p.shape) for p in grp["params"]] for grp in opt.param_groups]
    del model, opt
    n_el = [sum(int(np.prod(s)) for s in grp) for grp in shapes]
    print(f"[kernels] K12 (Adam update) vs plain: {len(shapes[0])} + {len(shapes[1])} leaves, "
          f"{n_el[0]} + {n_el[1]} = {sum(n_el)} trainable elements of the captioner, and a "
          f"1-element and an odd-sized leaf for the comparison", flush=True)
    extra = [(1,), (3, 10201 + 2)]
    shapes[0] += extra
    g = torch.Generator(device=DEV).manual_seed(4)
    hyper = dict(b1=0.9, b2=0.99, eps=1e-8)
    lrs = (1e-4, 1e-5)

    def leaves(scale):
        return [[torch.randn(s, generator=g, device=DEV) * scale for s in grp] for grp in shapes]

    # three steps of decay move a parameter by 3 * lr * wd of itself: 1.5e-5 in
    # the backbone group, so a kernel that ignored it fails in either group
    for wd in (0.0, 0.5):
        p0 = leaves(0.05)
        arms = {arm: ([[p.clone() for p in grp] for grp in p0],
                      [[torch.zeros_like(p) for p in grp] for grp in p0],
                      [[torch.zeros_like(p) for p in grp] for grp in p0])
                for arm in ("kernel", "plain")}
        tables = [None, None]
        for step in (1, 2, 3):
            grads = leaves(1e-2)
            for gi in range(2):
                kw = dict(step=step, lr=lrs[gi], weight_decay=wd, **hyper)
                ps, mus, nus = (a[gi] for a in arms["kernel"])
                tables[gi] = adam_ops.adam_update(ps, grads[gi], mus, nus, table=tables[gi], **kw)
                ps, mus, nus = (a[gi] for a in arms["plain"])
                adam_ops.adam_update_plain(ps, grads[gi], mus, nus, **kw)
        torch.cuda.synchronize()
        for j, part in enumerate(("parameters", "mu", "nu")):
            for gi, gname in enumerate(("model", "backbone")):
                worst, worst_abs = 0.0, 0.0
                for a, b in zip(arms["kernel"][j][gi], arms["plain"][j][gi]):
                    if not torch.isfinite(a).all():
                        fail(f"K12 wd={wd} {part}: non-finite leaf")
                    err = (a - b).abs().max().item()
                    worst_abs = max(worst_abs, err)
                    worst = max(worst, err / max(b.abs().max().item(), 1e-30))
                print(f"  K12 wd={wd} {gname:<9}{part:<11} after 3 steps: worst leaf max_rel "
                      f"{worst:.3e} (tol {ADAM_TOL:.0e})", flush=True)
                DETAIL.append({"kernel": "K12", "case": f"wd={wd} {gname} {part}",
                               "max_abs_err": worst_abs, "max_rel_err": worst, "tol": ADAM_TOL})
                rec = RESULTS.setdefault("K12", {"max_abs_err": 0.0})
                rec["max_abs_err"] = max(rec["max_abs_err"], worst_abs)
                if worst > ADAM_TOL:
                    fail(f"K12 wd={wd} {gname} {part}: max rel err {worst:.3e} > {ADAM_TOL:.0e}")
        if wd:
            continue
        # one update over both groups, as one training step makes it: the
        # model's own leaves, without the two added for the comparison
        grads = leaves(1e-2)
        grads[0] = grads[0][:-len(extra)]
        ps, mus, nus = ([grp[:-len(extra)] if gi == 0 else grp for gi, grp in enumerate(part)]
                        for part in arms["kernel"])
        tables = [None, None]

        def kernel():
            for gi in range(2):
                tables[gi] = adam_ops.adam_update(ps[gi], grads[gi], mus[gi], nus[gi], step=4,
                                                  lr=lrs[gi], table=tables[gi], **hyper)

        def plain():
            for gi in range(2):
                adam_ops.adam_update_plain(ps[gi], grads[gi], mus[gi], nus[gi], step=4,
                                           lr=lrs[gi], **hyper)

        lib_params = [[torch.nn.Parameter(p.clone()) for p in grp] for grp in ps]
        for grp, gr in zip(lib_params, grads):
            for p, gg in zip(grp, gr):
                p.grad = gg
        lib_opt = torch.optim.Adam([{"params": grp, "lr": lr} for grp, lr in zip(lib_params, lrs)],
                                   betas=(0.9, 0.99), eps=1e-8, fused=True)
        ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain, reps=3), cuda_ms(lib_opt.step)
        bound = 28.0 * sum(n_el) / PEAK_BYTES * 1e3
        print(f"  K12 one update of {sum(n_el)} elements in 2 launches: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, torch.optim.Adam(fused=True) {lib_ms:.3f} ms, bound "
              f"{bound:.3f} ms (28 bytes an element)", flush=True)
        RESULTS["K12"].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                              elements=sum(n_el), leaves=[len(grp) for grp in ps])


# grit_lsa's problems at the detector step: (6 decoder layers + the final
# level) x b4, 150 queries, max_boxes 100; the kernel phase's fills
LSA_FILLS = (0, 1, 20, 57, 100)
# an assignment's total cost against scipy's optimum on the same f32 costs,
# relative to max(1, |optimum|): the solver's potentials are f32
LSA_TOTAL_TOL = 1e-5
# a check_lsa row's numbers that the kernels line repeats
LSA_ROW_KEYS = ("ms", "plain_ms", "host_ms", "bound_ms", "iterations", "ns_per_iteration")


def lsa_bound_ms(cost: torch.Tensor) -> float:
    """The least time of one grit_lsa call: its f32 costs and int64 fills read
    once and its int64 assignments written once, over the card's memory
    rate.  A chain of dependent iterations bounds the kernel, not its bytes."""
    p, q, g = cost.shape
    return (p * q * g * 4 + p * 8 + p * g * 8) / PEAK_BYTES * 1e3


def host_lsa_ms(cost: torch.Tensor, n_valid: torch.Tensor, reps: int = 5) -> float:
    """Median wall ms of the host path on the same problems, as
    ``hungarian_match(impl="host")`` takes it: costs and fills to the host in
    one transfer, scipy a problem, the assignments back; synchronised."""
    def run():
        host = torch.cat([cost.reshape(-1), n_valid.to(cost.dtype)]).cpu().numpy()
        out = det_losses._host_lsa(host[:cost.numel()].reshape(cost.shape),
                                   host[cost.numel():].astype(np.int64))
        torch.from_numpy(out).to(cost.device)
        torch.cuda.synchronize()

    run()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def lsa_total_gap(cost: np.ndarray, assign: np.ndarray, n_valid: np.ndarray) -> float:
    """The largest excess of an assignment's total cost over scipy's optimum
    on the same costs, relative to max(1, |optimum|), over the problems."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    worst = 0.0
    for b, n in enumerate(n_valid.tolist()):
        if n == 0:
            continue
        rows, cols = scipy_lsa(cost[b, :, :n])
        best = cost[b, rows, cols].sum()
        ours = cost[b, assign[b, :n], np.arange(n)].sum()
        worst = max(worst, abs(ours - best) / max(1.0, abs(best)))
    return worst


def check_lsa(what: str, cost: torch.Tensor, n_valid: torch.Tensor) -> dict:
    """grit_lsa on ``cost`` [P, Q, G] (f32, on the card) against its plain
    version on the same tensors: assignments equal, bit-equal over two calls,
    one launch a call (read from a captured graph), valid rows each matched to
    a distinct query and -1 past the fill, every total within LSA_TOTAL_TOL of
    scipy's optimum; then the device ms by graph replay, the plain version's
    ms (counting each problem's Dijkstra iterations as it goes) and the host
    path's ms -> the row's numbers, with the longest problem's iterations and
    the kernel's ns an iteration of that chain."""
    before = lsa_ops.LAUNCHES["lsa"]
    out = lsa_ops.linear_sum_assignment(cost, n_valid)
    again = lsa_ops.linear_sum_assignment(cost, n_valid)
    torch.cuda.synchronize()
    if lsa_ops.LAUNCHES["lsa"] - before != 2:
        fail(f"grit_lsa {what}: two calls counted {lsa_ops.LAUNCHES['lsa'] - before} launches")
    t0 = time.perf_counter()
    plain, counts = lsa_ops.lsa_plain(cost, n_valid, return_counts=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    iterations = int(counts["iterations"].max())
    walk = int(counts["walk"].max())
    differ = int((out != plain).sum())
    a, nv = out.cpu().numpy(), n_valid.cpu().numpy()
    rows_ok = all(len(set(a[b, :n].tolist())) == n and (a[b, :n] >= 0).all() and
                  (a[b, n:] == -1).all() for b, n in enumerate(nv.tolist()))
    gap = lsa_total_gap(cost.double().cpu().numpy(), a, nv)
    launches = graph_launches(lambda: lsa_ops.linear_sum_assignment(cost, n_valid))
    ms = graph_ms(lambda: lsa_ops.linear_sum_assignment(cost, n_valid))
    host_ms = host_lsa_ms(cost, n_valid)
    bound = lsa_bound_ms(cost)
    print(f"  grit_lsa {what:<34} {differ} of {out.numel()} assignments differ from the plain "
          f"version's; bit-equal over two calls {torch.equal(out, again)}; total cost over "
          f"scipy's optimum {gap:.1e} (tol {LSA_TOTAL_TOL:.0e}); {launches} launch a call; "
          f"kernel {ms:.4f} ms (graph replay), plain {plain_ms:.1f} ms, host path (.cpu() + "
          f"scipy + back) {host_ms:.3f} ms, bound {bound * 1e3:.2f} us (bytes); longest "
          f"problem {iterations} Dijkstra iterations ({walk} walk steps): "
          f"{ms * 1e6 / iterations:.1f} ns an iteration", flush=True)
    if differ or not torch.equal(out, again) or not rows_ok or not gap <= LSA_TOTAL_TOL:
        fail(f"grit_lsa {what}: {differ} assignments differ from the plain version's, "
             f"bit-equal {torch.equal(out, again)}, rows valid {rows_ok}, total gap {gap:.3e}")
    if launches != 1:
        fail(f"grit_lsa {what}: a call makes {launches} CUDA launches, not 1")
    row = {"case": what, "problems": list(cost.shape), "fills": nv.tolist(), "ms": ms,
           "plain_ms": plain_ms, "host_ms": host_ms, "bound_ms": bound, "max_abs_err": 0,
           "total_gap": gap, "launches_a_call": launches, "iterations": iterations,
           "walk_steps": walk, "ns_per_iteration": ms * 1e6 / iterations}
    DETAIL.append({"kernel": "grit_lsa", **row})
    return row


def phase_lsa_kernel() -> None:
    """grit_lsa at the detector step's problem shape: (DET_LAYERS + 1) levels x
    DET_BATCH images of 150 queries x MAX_BOXES columns, the fills cycling
    through LSA_FILLS, on continuous costs (randn x 3) and on integer costs
    in 0..4 (ties everywhere, exact f32 arithmetic: the tie order)."""
    q = default_detection_config().model.detector.num_queries
    p = (DET_LAYERS + 1) * DET_BATCH
    n_valid = torch.tensor([LSA_FILLS[i % len(LSA_FILLS)] for i in range(p)], device=DEV)
    rng = np.random.default_rng(6000 + BATCH_SEED)
    for kind in ("continuous", "integer"):
        c = (rng.standard_normal((p, q, MAX_BOXES)) * 3 if kind == "continuous"
             else rng.integers(0, 5, (p, q, MAX_BOXES)))
        cost = torch.from_numpy(c.astype(np.float32)).to(DEV)
        RESULTS.setdefault("lsa", {"max_abs_err": 0})[kind] = check_lsa(
            f"{kind} [{p}, {q}, {MAX_BOXES}]", cost, n_valid)
    res = {k: v for k, v in ptxas_report().items() if k.startswith("lsa_kernel")}
    print(f"  grit_lsa registers a thread, spilled bytes: {res}; dynamic shared memory "
          f"{lsa_ops.smem_bytes(q, MAX_BOXES)} bytes a block", flush=True)


def grads_of(fn, leaves, gout):
    """Gradients of ``fn(*leaves)`` to every leaf under the output gradient ``gout``."""
    leaves = [t.detach().requires_grad_() for t in leaves]
    return torch.autograd.grad(fn(*leaves), leaves, gout)


def phase_merge_kernels(paths=None, counted: bool = True, preset: str = "") -> None:
    """K10a (PatchMerging: 2x2 gather, LayerNorm over 4C, reduction) and K10b
    (the patch-embed LayerNorm) against their plain versions, fp32 and bf16,
    forward and the gradient of every input against the plain version's
    autograd, at the shapes of the three main paths: a b8 caption forward and
    a b16 XE step at 384x640, a b4 detector step at 832x1344 (whose last merge
    pads 13x21 to 14x22), or at ``paths`` ((run, batch, stages, bucket), ...;
    ``counted=False``: a comparison only).  Library yardsticks, used nowhere
    in the port: F.layer_norm + F.linear on the gathered rows for K10a,
    F.layer_norm for K10b.  ``preset``: the stages are another Swin
    preset's (its last merge), checked and not timed."""
    import torch.nn.functional as F

    timer = no_time if preset else cuda_ms
    pos_dim = BACKBONES[preset]["pos_dim"] if preset else 1024
    print("[kernels] K10a (PatchMerging LN + reduction) and K10b (patch-embed LN) vs plain",
          flush=True)
    g = torch.Generator(device=DEV).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    paths = paths or (("caption", 8, STAGES, HW), ("train", TRAIN_BATCH, STAGES, HW),
                      ("detector", DET_BATCH, DET_STAGES, DET_HW))
    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        es = esize(dtype)
        for run, batch, stages, hw in paths:
            tag = f"b{batch} {hw[0]}x{hw[1]}" + (f" {preset}" if preset else "")
            rows, c = batch * (hw[0] // 4) * (hw[1] // 4), stages[0][1]
            x = (rnd(rows, c) * 2 + 0.5).to(dtype)
            ln = [1 + rnd(c, scale=0.1), rnd(c, scale=0.1)]
            gout = rnd(rows, c).to(dtype)
            out, ref = wa.layernorm_rows(x, *ln), wa.layernorm_rows_plain(x, *ln)
            lib = timer(lambda: F.layer_norm(x, (c,), ln[0].to(dtype), ln[1].to(dtype), 1e-5))
            compare("K10b", f"{dn} {tag}", out, ref, dtype,
                    timer(lambda: wa.layernorm_rows(x, *ln)),
                    timer(lambda: wa.layernorm_rows_plain(x, *ln)), int(counted),
                    (2.0 * rows * c * es + 8 * c, 8.0 * rows * c), run, library_ms=lib)
            for part, a, b in zip(("dx", "dscale", "dbias"),
                                  grads_of(wa.layernorm_rows, [x, *ln], gout),
                                  grads_of(wa.layernorm_rows_plain, [x, *ln], gout)):
                compare("K10b", f"{dn} {tag} {part}", a, b, dtype, 0.0, 0.0, 0)
            for k, (name, c, _, (h, w), _, _) in enumerate(stages):
                n_out = stages[k + 1][1] if k + 1 < len(stages) else pos_dim
                x = rnd(batch, h, w, c).to(dtype)
                ln = [1 + rnd(4 * c, scale=0.1), rnd(4 * c, scale=0.1)]
                wt = rnd(n_out, 4 * c, scale=(4 * c) ** -0.5).to(dtype)
                mrows = batch * ((h + 1) // 2) * ((w + 1) // 2)
                out, ref = wa.patch_merge(x, *ln, wt), wa.patch_merge_plain(x, *ln, wt)

                def library():
                    rows4 = wa._merge_rows(x)
                    return F.linear(F.layer_norm(rows4, (4 * c,), ln[0].to(dtype),
                                                 ln[1].to(dtype), 1e-5), wt)

                compare("K10a", f"{dn} {name} {tag}", out, ref, dtype,
                        timer(lambda: wa.patch_merge(x, *ln, wt)),
                        timer(lambda: wa.patch_merge_plain(x, *ln, wt)), int(counted),
                        ((batch * h * w * c + mrows * n_out + 4 * c * n_out) * es + 32 * c,
                         2.0 * mrows * 4 * c * n_out), run, library_ms=timer(library))
                gout = rnd(*out.shape).to(dtype)
                for part, a, b in zip(("dx", "dscale", "dbias", "dweight"),
                                      grads_of(wa.patch_merge, [x, *ln, wt], gout),
                                      grads_of(wa.patch_merge_plain, [x, *ln, wt], gout)):
                    compare("K10a", f"{dn} {name} {tag} {part}", a, b, dtype, 0.0, 0.0, 0)
        if not counted:
            continue
        # K10a on rows that are merged already (the JAX op's own signature)
        x = rnd(4, 77, 512).to(dtype)
        ln, wt = [1 + rnd(512, scale=0.1), rnd(512, scale=0.1)], rnd(256, 512, scale=0.05).to(dtype)
        compare("K10a", f"{dn} rows [4, 77, 512] -> 256", wa.ln_linear(x, *ln, wt),
                wa.ln_linear_plain(x, *ln, wt), dtype, cuda_ms(lambda: wa.ln_linear(x, *ln, wt)),
                cuda_ms(lambda: wa.ln_linear_plain(x, *ln, wt)), 0)


# the runs whose LayerNorm launches phase_ln_kernels times: (run, dtype,
# batch, stages, image size).  fp32 is both training CLIs' type
LN_RUNS = (("caption b8", torch.bfloat16, 8, STAGES, HW),
           ("caption b128", torch.bfloat16, 128, STAGES, HW),
           ("detector b4", torch.float32, DET_BATCH, DET_STAGES, DET_HW),
           ("detector b4", torch.bfloat16, DET_BATCH, DET_STAGES, DET_HW))
# an odd map [B, H, W, C] at stage 4's width: PatchMerging's zero edge,
# timed and checked beside the detector's shapes
LN_ODD_MAP = (4, 13, 21, 1024)


def ln_cases(run: str, batch: int, stages, hw) -> list:
    """The launches of ln_rows_kernel and ln_merge_kernel in one b``batch``
    caption forward or detector training step: [(label, kind, calls, C, map
    (B, Hp, Wp), real (h, w))], kind "rows", "window" or "merge".  A caption
    forward: K10b (the patch-embed norm), then at each stage K1's LN1 (window
    mode on the padded map, reading the real tokens), K2's LN2 (row mode on
    the padded map's rows) and K10a's norm over the 2x2 neighbourhoods of
    the real map.  A detector step (forward_train) runs LN1 as F.layer_norm
    and LN2 on the real rows; its K1 (the validation forward) and the odd
    map ``LN_ODD_MAP`` are timed with 0 calls."""
    train = run.startswith("detector")
    h0, w0 = hw[0] // 4, hw[1] // 4
    out = [("K10b", "rows", 1, stages[0][1], (batch, h0, w0), (h0, w0))]
    for name, c, _, (h, w), (hp, wp), depth in stages:
        out.append((f"K1 LN1 {name}", "window", 0 if train else depth, c, (batch, hp, wp), (h, w)))
        out.append((f"K2 LN2 {name}", "rows", depth, c,
                    (batch, h, w) if train else (batch, hp, wp), (h, w)))
        out.append((f"K10a {name}", "merge", 1, c, (batch, h, w), (h, w)))
    if train:
        b, h, w, c = LN_ODD_MAP
        out.append((f"K10a odd {h}x{w}", "merge", 0, c, (b, h, w), (h, w)))
    return out


def ln_case_inputs(case, dtype, g, shift: int = 0) -> dict:
    """One LN case's tensors on the card: ``launch(lib)`` gives a call of the
    kernel through ``lib``'s C entry (grit_ln_rows or grit_ln_merge, counted
    nowhere) into ``out``; ``plain()`` the plain version's output (window
    mode: the rows gathered in window order, pad rows zero); ``library()``
    F.layer_norm on the same rows (window mode: the padded map's rows; merge:
    the rows gathered already); ``bytes`` each input read once, each output
    written once (window mode reads the real tokens only)."""
    import torch.nn.functional as F

    _, kind, _, c, (b, hp, wp), (h, w) = case
    es = torch.finfo(dtype).bits // 8
    eps, code = wa.LN_EPS, _cuda.DTYPE_CODE[dtype]
    width = 4 * c if kind == "merge" else c

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    x = torch.zeros(b, hp, wp, c, dtype=dtype, device=DEV)
    x[:, :h, :w] = (rnd(b, h, w, c) * 2 + 0.5).to(dtype)
    nw, nb = 1 + rnd(width, scale=0.1), rnd(width, scale=0.1)
    if kind == "merge":
        rows = b * ((h + 1) // 2) * ((w + 1) // 2)
        gathered = wa._merge_rows(x).reshape(rows, width)
        src, nbytes = gathered, (b * h * w * c + rows * width) * es + 8 * width

        def launch(lib):
            return lambda: _cuda.check(lib.grit_ln_merge(
                x.data_ptr(), nw.data_ptr(), nb.data_ptr(), out.data_ptr(), rows, h, w, c, eps,
                code, _cuda.stream()), "ln_merge")
    else:
        rows = b * hp * wp
        src = x.view(rows, c)
        geo = (hp, wp, WINDOW, shift, h, w) if kind == "window" else (1, 1, 1, 0, 1, 1)
        read = b * h * w if kind == "window" else rows
        nbytes = (read + rows) * c * es + 8 * c

        def launch(lib):
            return lambda: _cuda.check(lib.grit_ln_rows(
                x.data_ptr(), nw.data_ptr(), nb.data_ptr(), out.data_ptr(), rows, c,
                int(kind == "window"), *geo, eps, code, _cuda.stream()), "ln_rows")
    out = torch.empty(rows, width, dtype=dtype, device=DEV)

    def plain():
        if kind != "window":
            return wa.layernorm_rows_plain(src, nw, nb, eps)
        tokens = wa._window_tokens(rows, geo).to(DEV)
        pad = ((tokens // wp) % hp >= h) | (tokens % wp >= w)
        return wa.layernorm_rows_plain(src[tokens], nw, nb, eps).masked_fill(pad[:, None], 0)

    def library():
        return F.layer_norm(src, (width,), nw.to(dtype), nb.to(dtype), eps)

    return {"launch": launch, "out": out, "plain": plain, "library": library,
            "bytes": nbytes, "rows": rows, "width": width}


def phase_ln_kernels(card: str) -> None:
    """ln_rows_kernel (the LayerNorm launch inside K1, K2 and K10b) and
    ln_merge_kernel (K10a's first launch) alone, through their C entries, at
    every shape of ``LN_RUNS`` (``ln_cases``): the b8 and b128 caption
    forwards in bf16, the b4 832x1344 detector step in fp32 and bf16, and an
    odd map.  Per shape: device time by graph_ms, the bound (bytes: each
    input read once, each output written once), its share, F.layer_norm on
    the same rows (the library yardstick), the largest error against the
    plain version (window mode at shift 0 and WINDOW // 2) within TOL, and
    two calls bit-equal; then the sums over the run's launches.  Timing
    launches: counted nowhere."""
    print("[ln] ln_rows_kernel and ln_merge_kernel alone at the caption and detector shapes",
          flush=True)
    lib = _cuda.library()
    g = torch.Generator(device=DEV).manual_seed(7)
    out = {}
    for run, dt, batch, stages, hw in LN_RUNS:
        dn = "bf16" if dt == torch.bfloat16 else "fp32"
        acc = {k: {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "launches": 0}
               for k in ("ln_rows_kernel", "ln_merge_kernel")}
        shapes = []
        for case in ln_cases(run, batch, stages, hw):
            label, kind, calls, c = case[:4]
            kernel = "ln_merge_kernel" if kind == "merge" else "ln_rows_kernel"
            err = 0.0
            # window mode checked at both shifts, timed at 0
            for shift in ((WINDOW // 2, 0) if kind == "window" else (0,)):
                t = ln_case_inputs(case, dt, g, shift)
                call = t["launch"](lib)
                call()
                first = t["out"].clone()
                call()
                if not torch.equal(first, t["out"]):
                    fail(f"{kernel} {run} {dn} {label}: two calls differ")
                ref = t["plain"]().float()
                err = max(err, ((first.float() - ref).abs().max() / ref.abs().max()).item())
                if not err <= TOL[dt]:
                    fail(f"{kernel} {run} {dn} {label}: max rel err {err:.3e} > {TOL[dt]:.0e}")
            # the median of three replays: a short launch's replay now and
            # then reads several times its time
            ms, lib_ms = (statistics.median(graph_ms(fn) for _ in range(3))
                          for fn in (call, t["library"]))
            bound = t["bytes"] / PEAK_BYTES * 1e3
            shapes.append({"label": label, "kernel": kernel, "kind": kind, "calls": calls,
                           "rows": t["rows"], "width": t["width"], "ms": ms, "bound_ms": bound,
                           "bound_share": bound / ms, "library_ms": lib_ms, "max_rel_err": err})
            a = acc[kernel]
            a["ms"] += calls * ms
            a["bound_ms"] += calls * bound
            a["library_ms"] += calls * lib_ms
            a["launches"] += calls
            print(f"[ln] {run} {dn} {label} ({kind}, {t['rows']} x {t['width']}, x{calls}): "
                  f"{kernel} {ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.0%}), "
                  f"F.layer_norm {lib_ms:.4f} ms, max rel err {err:.1e}, bit-equal  [{card}]",
                  flush=True)
            del t, first, ref
        for kernel, a in acc.items():
            a["bound_share"] = a["bound_ms"] / a["ms"]
            print(f"[ln] {run} {dn} {kernel}, summed over {a['launches']} launches: "
                  f"{a['ms']:.3f} ms (graph replay), bound {a['bound_ms']:.3f} ms by bytes "
                  f"({a['bound_share']:.0%} of it), F.layer_norm on the same rows "
                  f"{a['library_ms']:.3f} ms  [{card}]", flush=True)
        out[f"{run} {dn}"] = {**acc, "shapes": shapes}
    want = forward_launches()
    b8 = out["caption b8 bf16"]
    if (b8["ln_rows_kernel"]["launches"] != want["K1"] + want["K2"] + want["K10b"]
            or b8["ln_merge_kernel"]["launches"] != want["K10a"]):
        fail(f"ln kernels: launches {b8} differ from a forward's {want}")
    RESULTS["ln_kernels"] = out


# K2's backward at the shapes of the two training cells: the b64 XE step's
# three trained stages in bf16 and the b4 832x1344 detector step's four in
# fp32, on the real tokens (a training block's K2 runs on the unpadded rows)
MLP_BWD_RUNS = (("XE b64", torch.bfloat16, 64, STAGES[1:], HW),
                ("detector b4", torch.float32, DET_BATCH, DET_STAGES, DET_HW))


def phase_mlp_bwd_kernels(card: str) -> None:
    """K2's backward (``wa._mlp_backward``) at every shape of ``MLP_BWD_RUNS``.
    Its two passes alone against their plain versions on the card:
    ``gelu_bwd`` (g, du, the bias gradient) and ``ln_rows_bwd`` (dx, the
    norm's gradients; with the residual's dy at one shape a run), two calls
    bit-equal, device ms by graph replay beside the bound (each input read
    once, each output written once) and the plain version's.  The whole
    backward against autograd of ``_mlp_recompute`` (the float32 chain it
    replaces): every gradient within TOL, both timed by graph replay, the
    kernel launches of one call of each, and the counters of one call
    (``mlp_bwd``, ``gelu_bwd_*``, ``ln_rows_bwd_*`` one each, no GEMM
    kernel).  Then the sums over each run's calls (a stage's depth)."""
    print("[mlp_bwd] K2's backward at the XE b64 and detector b4 training shapes", flush=True)
    g = torch.Generator(device=DEV).manual_seed(22)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    def check(what, out, ref, dt):
        err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        if not err <= TOL[dt]:
            fail(f"{what}: max rel err {err:.3e} > {TOL[dt]:.0e}")
        return err

    out = {}
    for run, dt, batch, stages, hw in MLP_BWD_RUNS:
        dn = "bf16" if dt == torch.bfloat16 else "fp32"
        es = esize(dt)
        acc = collections.defaultdict(float)
        shapes = []
        for k, (name, c, _, (h, w), _, depth) in enumerate(stages):
            rows, hid = batch * h * w, 4 * c
            label = f"{run} {dn} {name} ({rows} x {c})"
            # the pre-activation of a Swin MLP at init is ~N(0, 1): fc1 on LN'd rows
            u, dg = rnd(rows, hid).to(dt), rnd(rows, hid, scale=0.02).to(dt)
            calls = []
            for _ in range(2):
                calls.append(wa.gelu_bwd(u.clone(), dg.clone()))
            ref = wa.gelu_bwd_plain(u, dg)
            if not all(bits_equal(a, b) for a, b in zip(*calls)):
                fail(f"gelu_bwd {label}: two calls differ")
            gelu_err = max(check(f"gelu_bwd {label} {part}", a, r, dt)
                           for part, a, r in zip(("g", "du", "db"), calls[0], ref))
            del calls, ref
            ub, dgb = u.clone(), dg.clone()   # overwritten call after call while timed
            gelu_ms = graph_ms(lambda: wa.gelu_bwd(ub, dgb))
            gelu_plain_ms = graph_ms(lambda: wa.gelu_bwd_plain(u, dg), reps=3)
            gelu_bound = (4 * rows * hid * es + hid * es) / PEAK_BYTES * 1e3
            del ub, dgb, u, dg

            x = (rnd(rows, c) * 2 + 0.5).to(dt)
            nw, nb = 1 + rnd(c, scale=0.1), rnd(c, scale=0.1)
            d_xn, dy = rnd(rows, c, scale=0.02).to(dt), rnd(rows, c, scale=0.02).to(dt)
            ln_err = 0.0
            for resid in ((None, dy) if k == 0 else (None,)):
                first = wa.ln_rows_bwd(x, nw, d_xn, resid)
                if not all(bits_equal(a, b) for a, b in zip(first, wa.ln_rows_bwd(x, nw, d_xn,
                                                                                 resid))):
                    fail(f"ln_rows_bwd {label}: two calls differ")
                ref = wa.ln_rows_bwd_plain(x, nw, d_xn, resid)
                ln_err = max(ln_err, *(check(f"ln_rows_bwd {label} {part}", a, r, dt)
                                       for part, a, r in zip(("dx", "dw", "db"), first, ref)))
            ln_ms = graph_ms(lambda: wa.ln_rows_bwd(x, nw, d_xn))
            ln_plain_ms = graph_ms(lambda: wa.ln_rows_bwd_plain(x, nw, d_xn), reps=3)
            ln_bound = (3 * rows * c * es + 12 * c) / PEAK_BYTES * 1e3

            params = [nw, nb, rnd(hid, c, scale=c ** -0.5).to(dt), rnd(hid, scale=0.02).to(dt),
                      rnd(c, hid, scale=hid ** -0.5).to(dt), rnd(c, scale=0.02).to(dt)]
            before = dict(wa.LAUNCHES)
            new = wa._mlp_backward(dy, x, *params, wa.LN_EPS, False)
            counted = {key: n - before[key] for key, n in wa.LAUNCHES.items() if n != before[key]}
            want = {"mlp_bwd": 1, f"gelu_bwd_{wa._dtype_name(dt)}": 1,
                    f"ln_rows_bwd_{wa._dtype_name(dt)}": 1}
            if counted != want:
                fail(f"K2 backward {label}: counters moved by {counted}, want {want}")

            def autograd_chain():
                leaves = [t.detach().requires_grad_() for t in (x, *params)]
                return torch.autograd.grad(
                    wa._mlp_recompute(*leaves, wa.LN_EPS, False), leaves, dy)

            old = autograd_chain()
            bwd_err = max(check(f"K2 backward {label} d{part}", a, r, dt) for part, a, r in
                          zip(("x", "norm_w", "norm_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b"),
                              new, old))
            del new, old
            bwd_ms = graph_ms(lambda: wa._mlp_backward(dy, x, *params, wa.LN_EPS, False))
            chain_ms = graph_ms(autograd_chain, reps=3)
            launches = graph_launches(lambda: wa._mlp_backward(dy, x, *params, wa.LN_EPS, False))
            chain_launches = graph_launches(autograd_chain)
            # the five products (u, dg, both weight gradients, d_xn) over the
            # peak, or each input and output once over the bandwidth
            bwd_bound = max(10.0 * rows * c * hid / PEAK_FLOPS[dt],
                            (3 * rows * c + 4 * c * hid) * es / PEAK_BYTES) * 1e3
            del x, d_xn, dy, params, first, ref
            row = {"label": label, "stage": name, "rows": rows, "width": c, "calls": depth,
                   "gelu_bwd_ms": gelu_ms, "gelu_bwd_bound_ms": gelu_bound,
                   "gelu_bwd_plain_ms": gelu_plain_ms, "gelu_bwd_max_rel_err": gelu_err,
                   "ln_rows_bwd_ms": ln_ms, "ln_rows_bwd_bound_ms": ln_bound,
                   "ln_rows_bwd_plain_ms": ln_plain_ms, "ln_rows_bwd_max_rel_err": ln_err,
                   "backward_ms": bwd_ms, "backward_bound_ms": bwd_bound,
                   "autograd_chain_ms": chain_ms, "backward_max_rel_err": bwd_err,
                   "backward_launches": launches, "autograd_chain_launches": chain_launches}
            shapes.append(row)
            for key in ("gelu_bwd_ms", "gelu_bwd_bound_ms", "gelu_bwd_plain_ms", "ln_rows_bwd_ms",
                        "ln_rows_bwd_bound_ms", "ln_rows_bwd_plain_ms", "backward_ms",
                        "backward_bound_ms", "autograd_chain_ms", "backward_launches",
                        "autograd_chain_launches"):
                acc[key] += depth * row[key]
            acc["calls"] += depth
            print(f"[mlp_bwd] {label} x{depth}: gelu_bwd {gelu_ms:.4f} ms (bound {gelu_bound:.4f},"
                  f" {gelu_bound / gelu_ms:.0%}; plain {gelu_plain_ms:.3f}; err {gelu_err:.1e}), "
                  f"ln_rows_bwd {ln_ms:.4f} ms (bound {ln_bound:.4f}, {ln_bound / ln_ms:.0%}; "
                  f"plain {ln_plain_ms:.3f}; err {ln_err:.1e}); backward {bwd_ms:.3f} ms in "
                  f"{launches} launches (bound {bwd_bound:.3f}) against the autograd chain "
                  f"{chain_ms:.3f} ms in {chain_launches} (err {bwd_err:.1e}); bit-equal  "
                  f"[{card}]", flush=True)
        print(f"[mlp_bwd] {run} {dn}, summed over {acc['calls']:.0f} calls: gelu_bwd "
              f"{acc['gelu_bwd_ms']:.3f} ms (bound {acc['gelu_bwd_bound_ms']:.3f}, plain "
              f"{acc['gelu_bwd_plain_ms']:.2f}), ln_rows_bwd {acc['ln_rows_bwd_ms']:.3f} ms "
              f"(bound {acc['ln_rows_bwd_bound_ms']:.3f}, plain "
              f"{acc['ln_rows_bwd_plain_ms']:.2f}); "
              f"backward {acc['backward_ms']:.2f} ms in {acc['backward_launches']:.0f} launches "
              f"(bound {acc['backward_bound_ms']:.2f}) against the autograd chain "
              f"{acc['autograd_chain_ms']:.2f} ms in {acc['autograd_chain_launches']:.0f}  "
              f"[{card}]", flush=True)
        out[f"{run} {dn}"] = {**acc, "shapes": shapes}
    RESULTS["mlp_bwd"] = out


def phase_dense_attention_kernel(batch: int) -> None:
    """K8 (the window-attention core on separate q, k, v and a dense bias)
    against its plain version, forward and backward (dq, dk, dv and the bias
    gradient in the bias's own shape), with a bias over one window and over
    every window, at the four Swin stage shapes of a b8 384x640 batch.  No
    model path of either package reaches it, so this phase is what holds it;
    its times are of the shapes with a bias over every window.  Library
    yardsticks, used nowhere in the port: scaled_dot_product_attention with an
    additive mask, and its backward with the mask requiring grad
    (``sdpa_bwd_ms``: dq, dk, dv and the bias gradient summed over images, as
    K8's), both timed by graph_ms."""
    import torch.nn.functional as F

    print(f"[kernels] K8 (window attention on a dense bias) vs plain, forward and backward, "
          f"b{batch} at {HW[0]}x{HW[1]}", flush=True)
    g = torch.Generator(device=DEV).manual_seed(6)
    n = WINDOW * WINDOW
    before = dict(wa.LAUNCHES)
    rec = RESULTS.setdefault("K8", {"max_abs_err": 0.0})
    rec.update({k: 0.0 for k in ("ms", "plain_ms", "bound_bytes_ms", "bound_ops_ms",
                                 "library_ms", "bwd_ms", "bwd_plain_ms", "bwd_bound_ms",
                                 "bwd_library_ms")})

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=DEV)

    for dtype in (torch.float32, torch.bfloat16):
        dn = "fp32" if dtype == torch.float32 else "bf16"
        es = esize(dtype)
        for name, c, heads, _, (hp, wp), _ in STAGES:
            nw = (hp // WINDOW) * (wp // WINDOW)
            d = c // heads
            scale = d ** -0.5
            q, k, v = (rnd(batch, nw, n, c).to(dtype) for _ in range(3))
            gout = rnd(batch, nw, n, c).to(dtype)
            for m in (1, nw):
                bias = rnd(m, heads, n, n)
                case = f"{dn} {name} bias over {m} window{'s' if m > 1 else ''}"
                args = (q, k, v, bias)

                def kernel_bwd():
                    return grads_of(lambda *a: wa.window_attention(*a, scale, heads), args, gout)

                def plain_bwd():
                    return grads_of(lambda *a: wa.window_attention_plain(*a, scale, heads), args,
                                    gout)

                out = wa.window_attention(*args, scale, heads)
                ref = wa.window_attention_plain(*args, scale, heads)
                ms = cuda_ms(lambda: wa.window_attention(*args, scale, heads))
                plain_ms = cuda_ms(lambda: wa.window_attention_plain(*args, scale, heads))
                work = (4.0 * q.numel() * es + bias.numel() * 4, 4.0 * q.numel() * n)
                compare("K8", case, out, ref, dtype, ms, plain_ms, 0, work)
                for part, a, b in zip(("dq", "dk", "dv", "dbias"), kernel_bwd(), plain_bwd()):
                    if a.shape != b.shape:
                        fail(f"K8 {case} {part}: shape {tuple(a.shape)} != {tuple(b.shape)}")
                    compare("K8", f"{case} {part}", a, b, dtype, 0.0, 0.0, 0)
                if dtype == torch.bfloat16 and m == nw:
                    qh, kh, vh = (t.reshape(batch * nw, n, heads, d).transpose(1, 2)
                                  for t in (q, k, v))
                    mask = bias.to(dtype).repeat(batch, 1, 1, 1)
                    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask, scale=scale))
                    gh = gout.reshape(batch * nw, n, heads, d).transpose(1, 2)
                    lib_bwd = sdpa_bwd_ms(qh, kh, vh, bias.to(dtype), gh, batch)
                    # the backward runs the forward first; time it net of that
                    bwd_ms = cuda_ms(kernel_bwd) - ms
                    bwd_plain = cuda_ms(plain_bwd, reps=3) - plain_ms
                    bwd_bytes = 8.0 * q.numel() * es + 2 * nw * heads * n * n * 4
                    rec["ms"] += ms
                    rec["plain_ms"] += plain_ms
                    rec["bound_bytes_ms"] += work[0] / PEAK_BYTES * 1e3
                    rec["bound_ops_ms"] += work[1] / PEAK_FLOPS[dtype] * 1e3
                    rec["library_ms"] += lib
                    rec["bwd_ms"] += bwd_ms
                    rec["bwd_plain_ms"] += bwd_plain
                    rec["bwd_library_ms"] += lib_bwd
                    rec["bwd_bound_ms"] += max(bwd_bytes / PEAK_BYTES,
                                               10.0 * q.numel() * n / PEAK_FLOPS[dtype]) * 1e3
                    print(f"  K8 {case:<30} backward {bwd_ms:.3f} ms (plain {bwd_plain:.3f}); "
                          f"SDPA + mask forward {lib:.3f} ms, backward {lib_bwd:.3f} ms "
                          f"(graph replay)", flush=True)
    rec["kernel_phase_launches"] = {
        "forward": wa.LAUNCHES["window_attention"] - before["window_attention"],
        "backward": wa.LAUNCHES["window_attention_grad"] - before["window_attention_grad"],
        **{f"backward kernel {dt}": wa.LAUNCHES[f"win_attn_bwd_{dt}"]
           - before[f"win_attn_bwd_{dt}"] for dt in ("bf16", "f32")}}
    if not all(rec["kernel_phase_launches"].values()):
        fail(f"K8: the phase launched no kernel: {rec['kernel_phase_launches']}")


def synthetic_batch(batch: int, offset: int = 0, hw=None) -> ImageBatch:
    """uint8 images from a seed in the ``hw`` bucket (default HW); every other
    image smaller than the bucket."""
    hw = hw or HW
    rng = np.random.default_rng(BATCH_SEED + offset)
    imgs = np.zeros((batch, *hw, 3), np.uint8)
    mask = np.ones((batch, *hw), bool)
    for i in range(batch):
        h, w = hw if i % 2 == 0 else (hw[0] * 3 // 4, hw[1] * 4 // 5)
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask[i, :h, :w] = False
    return ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)).to(DEV)


def core_launches() -> dict:
    """Launches of the bf16 GEMM, attention core and attention backward inside
    K1, K2, K4, K5, K8 and K10a."""
    return {"gemm_bf16": wa.LAUNCHES["gemm_bf16"], "win_attn": wa.LAUNCHES["win_attn_bf16"],
            "win_attn_bwd": wa.LAUNCHES["win_attn_bwd_bf16"]}


def f32_launches() -> dict:
    """Launches of the fp32 GEMM, attention core and attention backward."""
    return {k: wa.LAUNCHES[k] for k in ("gemm_f32", "win_attn_f32", "win_attn_bwd_f32")}


def caption_launches() -> dict:
    """Launches of the kernels a caption batch runs: K1, K2, K3, K10a and
    K10b in each Swin and detector forward, K11 in each parallel decode step."""
    return {"K1": wa.LAUNCHES["block_step"], "K2": wa.LAUNCHES["mlp"],
            "K3": msda_ops.LAUNCHES["msda"], "K10a": wa.LAUNCHES["ln_linear"],
            "K10b": wa.LAUNCHES["layernorm_rows"], "K11": tail_ops.LAUNCHES["decode_tail"]}


def forward_launches(forwards: int = 1, stages=None) -> dict:
    """What ``forwards`` Swin and detector forwards in eval() launch: each
    block one K1 and one K2, each decoder layer one K3, a PatchMerging a
    stage, one patch-embed norm.  ``stages``: the Swin's (default Swin-B's)."""
    stages = stages or STAGES
    blocks = sum(s[-1] for s in stages)
    return {"K1": blocks * forwards, "K2": blocks * forwards, "K3": DET_LAYERS * forwards,
            "K10a": len(stages) * forwards, "K10b": forwards}


def reset_launches() -> None:
    for d in (wa.LAUNCHES, msda_ops.LAUNCHES, tail_ops.LAUNCHES, adam_ops.LAUNCHES,
              lsa_ops.LAUNCHES):
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
    counts = {**caption_launches(), **core_launches()}
    blocks = sum(s[-1] for s in STAGES)
    # EOS is off, so each of the generator's layers takes K11 at every step; a
    # Swin forward makes one PatchMerging a stage and one patch-embed norm; K1
    # and K2 make two GEMM launches each, K10a one
    want = {**forward_launches(), "K11": config.model.cap_generator.n_layers * STEPS,
            "gemm_bf16": 4 * blocks + len(STAGES), "win_attn": blocks, "win_attn_bwd": 0}
    print(f"[slice] launches in one b{batch} caption batch: {counts} (want {want})")
    if counts != want:
        fail(f"kernel launch counts {counts} != {want}")
    for k, n in counts.items():
        RESULTS[k]["launches"] = n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total_launches = count_launches(lambda: gen(samples, batch))
    print(f"[slice] device kernels launched by one b{batch} caption batch: {total_launches} "
          f"(3860 before PatchMerging and the patch-embed norm went through K10a and K10b)")
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
                        "device_launches": total_launches, "images_per_s": batch / med,
                        "peak_gib": peak}


def phase_slice_b128(card: str, batch: int = 128) -> None:
    """One timed bf16 caption batch of ``batch`` images (beam 5, 20 steps, EOS
    off): the device-bound case.  One warm-up call, then 3 timed calls."""
    config = default_caption_config()
    model = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0)
    samples = synthetic_batch(batch)
    gen = make_caption_generator(model, beam_size=BEAM, max_len=STEPS,
                                 bos_idx=config.model.bos_idx, eos_idx=config.model.vocab_size)
    gen(samples, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = gen(samples, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = out.cpu()
    if tuple(out.shape) != (batch, STEPS) or out.min() < 0 or out.max() >= config.model.vocab_size:
        fail(f"b{batch} captions: bad tokens, shape {tuple(out.shape)}")
    med = sorted(times)[1]
    print(f"[slice b{batch}] b{batch} bf16 beam {BEAM} x {STEPS} steps at {HW[0]}x{HW[1]}: "
          f"{med * 1e3:.1f} ms/batch (median of 3: {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"{batch / med:.2f} images/s, peak {peak:.2f} GiB  [{card}]", flush=True)
    RESULTS["slice_b128"] = {"batch": batch, "seconds": times, "images_per_s": batch / med,
                             "peak_gib": peak}
    del model, gen


def phase_decode_graph(card: str, batch: int = 128, reps: int = 5) -> None:
    """The bf16 caption decode step issued op by op (``decode_step_eager``)
    against replayed from CUDA graphs (``decode_step``), b128 beam 5 x 20
    steps (EOS off) over one batch's visual inputs, in one process: the two
    searches' results bit for bit; the first graphed search's seconds (its
    captures) and the memory its graphs hold; wall ms a step (host clock over
    a synchronised search, ``reps`` of each in turns); and one profiled search
    of each: device busy ms a step and K11's kernels against its launch
    counter (a replay's kernels must reach the profiler's trace)."""
    config = default_caption_config()
    m = config.model
    model = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0)
    gen = model.cap_generator
    with torch.inference_mode():
        vis = model.compute_vis(synthetic_batch(batch))
        kv = model.precompute_vis_kv(vis)

    def search(step):
        with torch.inference_mode():
            return beam_search(
                lambda tok, t, v, c: step(tok, t, v, c, vis_kv=kv, vis_fold=BEAM),
                model.init_cache(batch * BEAM, STEPS), vis, batch, BEAM, STEPS, m.bos_idx,
                m.vocab_size)

    steps = {"eager": gen.decode_step_eager, "graphed": gen.decode_step}
    ref = search(steps["eager"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held0, pool0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    first = search(steps["graphed"])
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    # what stays reserved once the cache is emptied: the buffers and the
    # graphs' private pool
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - held0
    pool = torch.cuda.memory_reserved() - pool0
    for name, res in (("first graphed", first), ("graphed", search(steps["graphed"]))):
        if not all(torch.equal(a, b) for a, b in zip(res, ref) if a is not None):
            fail(f"decode graph: the {name} search differs from the eager one")
    wall = {name: [] for name in steps}
    for _ in range(reps):
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search(step)
            torch.cuda.synchronize()
            wall[name].append((time.perf_counter() - t0) * 1e3 / STEPS)
    out = {"batch": batch, "capture_s": capture_s, "held_bytes": held, "pool_bytes": pool,
           "sets": len(gen.step_graphs.sets)}
    for name, step in steps.items():
        before = tail_ops.LAUNCHES["decode_tail"]
        prof = profile_run(lambda: search(step), f"b{batch} decode {name} [{card}]",
                           f"decode_graph_{name}.txt", lines_shown=6, kernel="dt_")
        counted = tail_ops.LAUNCHES["decode_tail"] - before
        out[name] = {"wall_ms_a_step": wall[name], "busy_ms_a_step": prof["busy_ms"] / STEPS,
                     "idle_share": prof["idle_share"], "launches": prof["launches"],
                     "dt_kernels": prof["kernel_launches"], "decode_tail_counted": counted}
        if prof["kernel_launches"] != 8 * counted:
            print(f"[decode graph] {name}: {prof['kernel_launches']} K11 kernels in the "
                  f"profile, {8 * counted} counted", flush=True)
    med = {name: statistics.median(wall[name]) for name in steps}
    print(f"[decode graph] b{batch} beam {BEAM} x {STEPS}: wall a step eager "
          f"{med['eager']:.3f} ms, graphed {med['graphed']:.3f} ms; device busy a step "
          f"{out['eager']['busy_ms_a_step']:.3f} / {out['graphed']['busy_ms_a_step']:.3f} ms; "
          f"first graphed search {capture_s:.2f} s, graphs hold {held / 2 ** 20:.1f} MiB "
          f"(reserved +{pool / 2 ** 20:.1f} MiB); results bit-equal  [{card}]", flush=True)
    RESULTS["decode_graph"] = out
    del model, gen, vis, kv


def profile_run(fn, title: str, path: str, lines_shown: int = 22, kernel: str = "") -> dict:
    """torch.profiler over one call of ``fn``: device busy time and the
    kernels that take it, written to chiprun_out/<path> (the first
    ``lines_shown`` lines printed) -> wall and busy ms, idle share, launches,
    and with ``kernel`` the device ms and launches of the kernels whose name
    holds it."""
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
        # a profiler annotation (Optimizer.step#Adam.step, the port's grit.* spans)
        # spans its kernels: not a kernel
        if (dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith(("Optimizer.", "grit."))):
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
    print("[profile] " + "\n[profile] ".join(lines[:lines_shown]), flush=True)
    out = {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3, "idle_share": 1 - busy / wall,
           "launches": sum(r[1] for r in rows)}
    if kernel:
        hit = [(us, n) for us, n, name in rows if kernel in name]
        out.update(kernel_ms=sum(us for us, _ in hit) / 1e3, kernel_launches=sum(n for _, n in hit))
    return out


def phase_profile(batch: int, card: str) -> None:
    """Profile one bf16 caption batch at ``batch`` and at 128 images, one bf16
    XE training step and one detector training step in bf16 and in fp32."""
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
    big = synthetic_batch(128)   # the device-bound batch of phase_slice_b128
    gen(big, 128)
    torch.cuda.synchronize()
    profile_run(lambda: gen(big, 128), f"b128 bf16 caption batch [{card}]", "profile_b128.txt")
    del model, gen, big
    state, step, tbatch = training_setup(config, torch.bfloat16, TRAIN_BATCH)
    step(state, tbatch)
    torch.cuda.synchronize()
    profile_run(lambda: step(state, tbatch),
                f"b{TRAIN_BATCH} bf16 XE training step [{card}]", "profile_train.txt")
    del state, step, tbatch
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        config, state, _, step = detector_setup(dtype)
        images = detector_images(DET_BATCH).to(DEV)
        targets = {k: torch.from_numpy(v).to(DEV) for k, v in detector_targets(
            DET_BATCH, config.model.detector.num_classes).items()}
        targets["labels"] = targets["labels"].long()
        step(state, images, targets)
        torch.cuda.synchronize()
        profile_run(lambda: step(state, images, targets),
                    f"b{DET_BATCH} {dn} detector training step at {DET_HW[0]}x{DET_HW[1]} [{card}]",
                    f"profile_detector_{dn}.txt")
        del state, step


@contextlib.contextmanager
def plain_arm():
    """Swap the kernel wrappers for their plain versions, differentiated by
    autograd, the decode layers' fused tail for their module path and the
    matcher's kernel for ``lsa_plain`` (comparison only)."""
    saved = wa.block_step, wa.mlp, msda_ops.msda, wa.block_attention_train
    saved_ln = wa.patch_merge, wa.layernorm_rows
    saved_tail = cap_generator_lib.use_fused_tail
    saved_graphable = cap_generator_lib.CaptionGenerator.graphable
    saved_lsa = lsa_ops.linear_sum_assignment
    lsa_ops.linear_sum_assignment = lsa_ops.lsa_plain
    wa.block_step, wa.mlp, msda_ops.msda = wa.block_step_plain, wa.mlp_plain, msda_ops.msda_plain
    wa.block_attention_train = wa.block_attention_train_plain
    wa.patch_merge, wa.layernorm_rows = wa.patch_merge_plain, wa.layernorm_rows_plain
    # K11's plain arm is the decode layer's module path, issued op by op: a
    # graph captured on the kernel arm would replay K11
    cap_generator_lib.use_fused_tail = lambda layer, x: False
    cap_generator_lib.CaptionGenerator.graphable = lambda self, token: False
    try:
        yield
    finally:
        wa.block_step, wa.mlp, msda_ops.msda, wa.block_attention_train = saved
        wa.patch_merge, wa.layernorm_rows = saved_ln
        cap_generator_lib.use_fused_tail = saved_tail
        cap_generator_lib.CaptionGenerator.graphable = saved_graphable
        lsa_ops.linear_sum_assignment = saved_lsa


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


@torch.inference_mode()
def beam_run(model, samples, batch: int, bos: int, eos: int, beam: int = BEAM, **kw):
    """-> (visual features, beam_search's result) of one batch, as
    make_caption_generator runs it; ``kw`` goes to beam_search."""
    vis = model.compute_vis(samples)
    kv = model.precompute_vis_kv(vis)
    res = beam_search(
        lambda tok, t, v, c: model.decode_step(tok, t, v, c, vis_kv=kv, vis_fold=beam),
        model.init_cache(batch * beam, STEPS), vis, batch, beam, STEPS, bos, eos, **kw)
    return vis, res


def same_tokens(what: str, seq_k: torch.Tensor, seq_p: torch.Tensor, margins) -> None:
    """The kernel path's fp32 tokens [B, T] against the plain path's: equal,
    or different only from a step whose decision margin (the kernel path's
    ``margins`` [B, T]) is a near-tie."""
    seq_k, seq_p = seq_k.cpu(), seq_p.cpu()
    same = (seq_k == seq_p).all(1)
    print(f"[{what}] fp32 tokens equal token for token on {int(same.sum())}/{len(same)} images")
    for i in torch.nonzero(~same).flatten().tolist():
        step = int(torch.nonzero(seq_k[i] != seq_p[i])[0])
        gap = float(margins[i, step])
        print(f"[{what}] image {i}: first differing step {step}, decision margin there "
              f"{gap:.3e} (smallest over the run {float(margins[i].min()):.3e})")
        if gap > NEAR_TIE:
            fail(f"{what}: image {i} tokens differ without a near-tie ({gap:.3e})")


def phase_parity(batch: int) -> None:
    config = default_caption_config()
    vocab = config.model.vocab_size
    model = build_captioner(config, device=DEV, dtype=torch.float32, seed=0)
    samples = synthetic_batch(batch)
    det_out = []
    hook = model.detector.det_module.register_forward_hook(
        lambda mod, args, out: det_out.append(out))

    def run():
        return beam_run(model, samples, batch, config.model.bos_idx, vocab, return_margins=True)

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
    same_tokens("parity", res_k.sequences[:, 0], res_p.sequences[:, 0], res_k.margins.cpu())


SCHED = dict(num_epochs=10, num_its_per_epoch=1000, init_lr=1e-4, min_lr=1e-4,
             warmup_init_lr=1e-5)


def training_captions(batch: int, config, offset: int = 0) -> torch.Tensor:
    """Captions of CAPTION_LEN tokens from a seed (BOS, random words, EOS, then
    a pad tail of 0-7 tokens), on the card."""
    rng = np.random.default_rng(1000 + BATCH_SEED + offset)
    m = config.model
    caps = rng.integers(4, m.vocab_size, (batch, CAPTION_LEN))
    caps[:, 0] = m.bos_idx
    for i in range(batch):
        end = CAPTION_LEN - 1 - i % 8
        caps[i, end] = m.eos_idx
        caps[i, end + 1:] = m.pad_idx
    return torch.from_numpy(caps).to(DEV)


def training_batch(batch: int, config, offset: int = 0) -> dict:
    """Synthetic XE batch from a seed: the inference phase's images and
    ``training_captions``."""
    return {"samples": synthetic_batch(batch, offset),
            "captions": training_captions(batch, config, offset)}


def training_setup(config, dtype, batch: int, dropouts: bool = True, seed: int = 0,
                   tp_group=None):
    """The XE trainer a user would build: model in train() with f32 master
    parameters computing in ``dtype``, two-group Adam with the frozen Swin
    stages left out, the cosine schedule, a seeded generator for the masks.
    ``tp_group``: the model split over that tensor group before the optimizer
    is built (``parallel.mesh.shard_model``)."""
    config = config.copy()
    config.model.frozen_stages = FROZEN_STAGES
    model = build_captioner(config, device=DEV, dtype=dtype, seed=seed, train=True)
    if not dropouts:
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
            elif isinstance(mod, SwinBlock):
                mod.drop_path_rate = 0.0
    if tp_group is not None:
        shard_model(model, tp_plan(model, tp_size(tp_group)), tp_group)
    freeze = optim_lib.frozen_mask(model, optim_lib.swin_frozen_stages_predicate(FROZEN_STAGES))
    opt = optim_lib.build_optimizer(
        model, model_lr=SCHED["init_lr"], backbone_lr=config.optimizer.xe_backbone_lr,
        beta_1=config.optimizer.beta_1, beta_2=config.optimizer.beta_2, freeze=freeze)
    if tp_group is not None:
        tie_replicated_grads(opt, model, tp_group)
    state = xe_lib.TrainState(model, opt, global_steps=1,
                              generator=torch.Generator(device=DEV).manual_seed(seed))
    step = xe_lib.make_xe_train_step(pad_idx=config.model.pad_idx, sched_cfg=SCHED)
    return state, step, training_batch(batch, config)


def train_launches() -> dict:
    return {"K1": wa.LAUNCHES["block_step"], "K2": wa.LAUNCHES["mlp"],
            "K3": msda_ops.LAUNCHES["msda"], "K4": wa.LAUNCHES["block_attention"],
            "K5": wa.LAUNCHES["window_attention_bwd"], "K6": msda_ops.LAUNCHES["msda_bwd"],
            "K10a": wa.LAUNCHES["ln_linear"], "K10b": wa.LAUNCHES["layernorm_rows"],
            "K12": adam_ops.LAUNCHES["adam"], **core_launches()}


def mlp_bwd_launches(dtype) -> dict:
    """K2's backward calls and the launches of its two passes in ``dtype``."""
    dn = wa._dtype_name(dtype)
    return {"K2 bwd": wa.LAUNCHES["mlp_bwd"], "gelu_bwd": wa.LAUNCHES[f"gelu_bwd_{dn}"],
            "ln_rows_bwd": wa.LAUNCHES[f"ln_rows_bwd_{dn}"]}


def train_want(stages=None) -> dict:
    """What one bf16 XE step of ``training_setup`` launches (``stages``: its
    Swin's, default Swin-B's)."""
    stages = stages or STAGES
    frozen = sum(s[-1] for s in stages[:FROZEN_STAGES - 1])
    trained = sum(s[-1] for s in stages[FROZEN_STAGES - 1:])
    return {"K1": frozen, "K2": frozen + trained, "K3": DET_LAYERS, "K4": trained,
            "K5": trained, "K6": DET_LAYERS, "K10a": len(stages), "K10b": 1,
            "K12": 2,   # one Adam launch per parameter group
            # two GEMM launches in each of K1, K2 and K4, one in K10a
            "gemm_bf16": 2 * (frozen + (frozen + trained) + trained) + len(stages),
            "win_attn": frozen + trained, "win_attn_bwd": trained}


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
    counts, want = train_launches(), train_want()
    print(f"[train] launches in one b{batch} XE step: {counts} (want {want}); of the fp32 "
          f"kernels {f32_launches()} (want none)")
    if counts != want or any(f32_launches().values()):
        fail(f"training kernel launch counts {counts} != {want}, fp32 {f32_launches()}")
    # K2's backward once a trained block, each of its passes once a call
    bwd = mlp_bwd_launches(torch.bfloat16)
    print(f"[train] K2's backward in one step: {bwd} (want {want['K4']} each)")
    if set(bwd.values()) != {want["K4"]}:
        fail(f"training: K2's backward launches {bwd}, want {want['K4']} each")
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


def on_host(batch: ImageBatch) -> ImageBatch:
    return ImageBatch(batch.images.cpu(), batch.mask.cpu())


def on_stream(fn, spans: list, calls: list | None = None):
    """``fn`` with a CUDA event recorded on the stream before and after each
    call and no wait for the device (the loops' pipelining stays as it is);
    the spans are read when the epoch is over, each beside the host's time in
    the call.  ``calls`` keeps the arguments."""
    def wrapped(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        spans.append((a, b, host_ms))
        if calls is not None:
            calls.append(args)
        return out
    return wrapped


def span_ms(spans: list) -> tuple[list[float], list[float]]:
    """(ms between the two events on the stream, ms the host spent in the call), per call."""
    torch.cuda.synchronize()
    return ([round(a.elapsed_time(b), 1) for a, b, _ in spans],
            [round(host, 1) for _, _, host in spans])


def synthetic_text_field(vocab_size: int) -> TextField:
    """A vocabulary of ``vocab_size`` ids (the specials and words ``w0``,
    ``w1``, ...), whose decoding stops at no word."""
    return TextField(vocab=Vocab(counter=collections.Counter(
        {f"w{i}": 5 for i in range(vocab_size - len(SPECIALS))})), eos_token="<off>")


def phase_trainer(card: str) -> None:
    """The caption trainer's path at full width, bf16 over f32 master
    parameters, frozen_stages=2, dropouts on, random weights (seed 0),
    synthetic 384x640 images, through the trainer's own loops over in-memory
    loaders: ``train_xe_epoch`` over two b16 batches and a validation batch;
    ``train_sc_epoch`` over two b8 batches (beam-5 generation of 20 steps,
    batch 1's queued before batch 0's CIDEr rewards are computed on the host
    and its update changes the parameters); evaluate_metrics over two batches
    in eval(); a checkpoint saved and restored into a freshly built model and
    optimizer, after which one more SCST update from each must give the same
    loss."""
    import tempfile

    config = default_caption_config()
    m = config.model
    vocab_size, layers = m.vocab_size, m.cap_generator.n_layers
    state, xe_step, _ = training_setup(config, torch.bfloat16, TRAIN_BATCH)
    model = state.model
    # the search's EOS is off, so decoding stops at no word either
    text_field = synthetic_text_field(vocab_size)
    eval_loss_step = xe_lib.make_eval_loss_step(model, pad_idx=m.pad_idx)

    def xe_loader_batch(offset: int) -> dict:
        b = training_batch(TRAIN_BATCH, config, offset)
        return {"samples": on_host(b["samples"]), "captions": b["captions"].cpu().numpy()}

    loaders = {"train": [xe_loader_batch(0), xe_loader_batch(1)], "valid": [xe_loader_batch(2)]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()

    def launches() -> dict:
        return {**train_launches(), "K11": tail_ops.LAUNCHES["decode_tail"]}

    # -- XE ---------------------------------------------------------------
    xe_spans: list = []
    t0 = time.perf_counter()
    state, xe_res = loops_lib.train_xe_epoch(
        on_stream(xe_step, xe_spans), eval_loss_step, state, loaders, epoch=0, device=DEV,
        pad_idx=m.pad_idx, bos_idx=m.bos_idx)
    (xe_ms, xe_host), xe_s = span_ms(xe_spans), time.perf_counter() - t0
    print(f"[trainer] train_xe_epoch, 2 steps b{TRAIN_BATCH} and the validation loss: {xe_res}, "
          f"steps {xe_ms} ms on the stream ({xe_host} ms of the host in the call), epoch "
          f"{xe_s:.2f} s")
    if not np.isfinite([xe_res["loss"], xe_res["val_loss"]]).all() or len(xe_ms) != 2:
        fail(f"trainer: XE epoch {xe_res} over {len(xe_ms)} steps")
    if adam_ops.LAUNCHES["adam"] != 4:
        fail(f"trainer: K12 launched {adam_ops.LAUNCHES['adam']} times in 2 XE steps, want 4")

    # -- SCST -------------------------------------------------------------
    # EOS is set outside the vocabulary so that every beam runs all 20 steps
    beam = dict(beam_size=BEAM, max_len=STEPS, bos_idx=m.bos_idx, eos_idx=vocab_size)
    generate = scst_lib.make_generate_step(model, **beam)
    update = scst_lib.make_scst_update_step(
        bos_idx=m.bos_idx, eos_idx=vocab_size, model_lr=config.optimizer.sc_lr,
        backbone_lr=config.optimizer.sc_backbone_lr)
    sc_samples = [synthetic_batch(SC_BATCH, 3 + j) for j in range(2)]
    # References that random weights can earn a reward from: the epoch's own
    # generations, made ahead from a copy of the generator's state (the epoch
    # queues both batches' generations before its first update, so it draws the
    # same masks on the same parameters), five an image: the words of the
    # image's first beam, each with a random third of them replaced
    rng = np.random.default_rng(2000 + BATCH_SEED)
    gen_state = state.generator.get_state()
    ahead, ahead_ms = [], []
    for samples in sc_samples:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ahead.append(generate(samples, SC_BATCH, state.generator)[0])
        torch.cuda.synchronize()
        ahead_ms.append(round((time.perf_counter() - t0) * 1e3, 1))
    state.generator.set_state(gen_state)
    loaders["train_dict"] = []
    for j, sequences in enumerate(ahead):
        caps_gen = text_field.decode(sequences.cpu().numpy().reshape(-1, STEPS))
        refs = []
        for b in range(SC_BATCH):
            words = caps_gen[b * BEAM].split() or ["w0"]
            refs.append([" ".join(w if rng.random() > 1 / 3 else f"w{rng.integers(0, 1000)}"
                                  for w in words) for _ in range(5)])
        loaders["train_dict"].append({
            "samples": on_host(sc_samples[j]), "captions": refs,
            "image_id": list(range(j * SC_BATCH, (j + 1) * SC_BATCH))})
    all_refs = [r for batch in loaders["train_dict"] for r in batch["captions"]]
    cider = Cider(PTBTokenizer.tokenize(all_refs))

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    held = {id(p) for grp in state.optimizer.param_groups for p in grp["params"]}
    counts_before = launches()
    gen_spans, upd_spans, gen_calls, upd_calls = [], [], [], []
    t0 = time.perf_counter()
    state, sc_res = loops_lib.train_sc_epoch(
        on_stream(generate, gen_spans, gen_calls), on_stream(update, upd_spans, upd_calls),
        eval_loss_step, state, loaders, cider, text_field, beam_size=BEAM, epoch=1, device=DEV,
        pad_idx=m.pad_idx, bos_idx=m.bos_idx)
    (gen_ms, gen_host), (upd_ms, upd_host) = span_ms(gen_spans), span_ms(upd_spans)
    sc_s = time.perf_counter() - t0
    print(f"[trainer] train_sc_epoch, 2 iterations b{SC_BATCH} beam {BEAM} x {STEPS} and the "
          f"validation loss: {sc_res}, generate {gen_ms} ms on the stream ({gen_host} ms of the "
          f"host in the call; {ahead_ms} ms for the same generations ahead of the epoch, each "
          f"waited for), update {upd_ms} ms ({upd_host}), epoch {sc_s:.2f} s", flush=True)
    if len(gen_ms) != 2 or len(upd_ms) != 2 or not np.isfinite(list(sc_res.values())).all():
        fail(f"trainer: SCST epoch {sc_res} over {len(gen_ms)} generations, {len(upd_ms)} updates")
    if not sc_res["reward"] > 0 or sc_res["loss"] == 0:
        fail(f"trainer: the SCST epoch earned no reward or had no loss: {sc_res}")
    same = 0
    for j, (_, _, sequences, reward, n_valid) in enumerate(upd_calls):
        same += int((sequences == ahead[j]).all(-1).sum())
        print(f"[trainer] SCST iteration {j}: sequences {tuple(sequences.shape)}, rewards "
              f"{reward.shape} in [{reward.min():.3f}, {reward.max():.3f}], n_valid {n_valid}")
        if tuple(sequences.shape) != (SC_BATCH, BEAM, STEPS) or reward.shape != (SC_BATCH, BEAM):
            fail("trainer: SCST sequences or rewards of the wrong shape")
        if not (reward - reward.mean(1, keepdims=True)).any():
            fail("trainer: every beam got its image's mean reward: the update has no signal")
    # batch 1 was generated before batch 0's update: it saw the parameters the
    # generations made ahead saw
    print(f"[trainer] {same} of {2 * SC_BATCH * BEAM} sequences equal those generated ahead of "
          f"the epoch")
    if same < SC_BATCH * BEAM:
        fail("trainer: the epoch's generations differ from those made ahead from the same "
             "parameters and generator state")
    counts = launches()
    if counts["K12"] - counts_before["K12"] != 4:
        fail("trainer: the SCST updates did not launch K12 once per parameter group each")
    if counts["K11"] != counts_before["K11"]:
        fail("trainer: generation under live dropout went through K11")
    # the rewards came from the native CIDEr-D: the pure-Python scorer on the
    # same captions gives them to 1e-10, and each reward passed is its f32
    cider_py = Cider(PTBTokenizer.tokenize(all_refs, use_native=False), use_native=False)
    worst = 0.0
    for j, (_, _, sequences, reward, _) in enumerate(upd_calls):
        refs = loaders["train_dict"][j]["captions"]
        seqs = sequences.cpu().numpy()[:len(refs)]
        caps_gen = text_field.decode(seqs.reshape(-1, seqs.shape[-1]))
        caps_gt = [c for c in refs for _ in range(BEAM)]
        native_r = cider.compute_score(PTBTokenizer.tokenize(caps_gt),
                                       PTBTokenizer.tokenize(caps_gen))[1]
        python_r = cider_py.compute_score(PTBTokenizer.tokenize(caps_gt, use_native=False),
                                          PTBTokenizer.tokenize(caps_gen, use_native=False))[1]
        worst = max(worst, float(np.max(np.abs(native_r - python_r)
                                        / np.maximum(np.abs(python_r), 1e-30))))
        if not np.array_equal(np.asarray(reward)[:len(refs)].reshape(-1),
                              native_r.astype(np.float32)):
            fail(f"trainer: SCST iteration {j}'s rewards are not the native CIDEr-D's")
    print(f"[trainer] SCST rewards: the native CIDEr-D's, within {worst:.1e} (tol 1e-10) of the "
          f"pure-Python scorer's on the same captions", flush=True)
    if worst > 1e-10:
        fail(f"trainer: native and pure-Python CIDEr-D rewards differ by {worst:.3e}")
    moved, stuck, frozen_moved = 0, [], 0
    for n, p in model.named_parameters():
        changed = not torch.equal(p.detach(), before[n])
        if not torch.isfinite(p).all():
            fail(f"trainer: parameter {n} is non-finite after SCST")
        if id(p) not in held:
            frozen_moved += changed
        elif p.grad is not None and p.grad.abs().max() > 0:
            moved += changed
            if not changed:
                stuck.append(n)
    print(f"[trainer] SCST moved {moved} trainable parameters with a gradient ({len(held)} "
          f"in the optimizer), left {len(stuck)} of them unchanged, moved {frozen_moved} frozen "
          f"ones")
    if not moved or stuck or frozen_moved:
        fail(f"trainer: SCST left parameters with a gradient unchanged ({stuck[:5]}) or moved "
             f"frozen ones")
    del before

    # -- evaluation ---------------------------------------------------------
    model.eval()
    eval_gen = make_caption_generator(model, **beam)
    loader = [{"samples": on_host(synthetic_batch(EVAL_BATCH, 5 + j)),
               "image_id": list(range(j * EVAL_BATCH, (j + 1) * EVAL_BATCH)),
               "captions": [all_refs[k % len(all_refs)] for k in range(EVAL_BATCH)]}
              for j in range(2)]
    tail_before = tail_ops.LAUNCHES["decode_tail"]
    scores, results, avg_s = evaluate_metrics(eval_gen, loader, text_field, device=DEV,
                                              verbose=False)
    tails = tail_ops.LAUNCHES["decode_tail"] - tail_before
    print(f"[trainer] evaluate_metrics over 2 batches of {EVAL_BATCH} in eval(): "
          f"{avg_s * 1e3:.1f} ms/batch, K11 launches {tails} (want {2 * layers * STEPS}), "
          f"scores {json.dumps(scores)}", flush=True)
    if tails != 2 * layers * STEPS:
        fail(f"trainer: evaluation launched K11 {tails} times, want {2 * layers * STEPS}")
    flat = [scores[k] for k in ("CIDEr", "ROUGE", "METEOR")] + list(scores["BLEU"])
    if len(results) != 2 * EVAL_BATCH or not all(np.isfinite(flat)):
        fail(f"trainer: evaluation scores {scores}, {len(results)} results")

    # -- checkpoint ---------------------------------------------------------
    with tempfile.TemporaryDirectory() as workdir:
        ckpt_lib.save_checkpoint(workdir, "last", state=state, epoch=1,
                                 best_ciders=(scores["CIDEr"], 0.0), config=config)
        size_mb = os.path.getsize(os.path.join(workdir, "checkpoints", "last",
                                               ckpt_lib.STATE_FILE)) / 2 ** 20
        state2, _, _ = training_setup(config, torch.bfloat16, TRAIN_BATCH, seed=1)
        restored = ckpt_lib.restore_checkpoint(workdir, "last")
        ckpt_lib.load_train_state(state2, restored)
    losses = []
    for st in (state, state2):
        _, metrics = update(st, *upd_calls[-1][1:])
        losses.append(float(metrics["loss"]))
    rel = abs(losses[0] - losses[1]) / max(abs(losses[0]), 1e-30)
    print(f"[trainer] checkpoint ({size_mb:.0f} MiB) restored into a fresh model and "
          f"optimizer: next SCST loss {losses[0]:.9f} vs {losses[1]:.9f}, rel diff {rel:.3e} "
          f"(tol 1e-06), epoch {restored['epoch']}, ticks {state2.global_steps}")
    if not np.isfinite(losses).all() or rel > 1e-6 or state2.global_steps != state.global_steps:
        fail(f"trainer: checkpoint round trip: losses {losses}")
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[trainer] kernel launches over the phase: {counts}; peak {peak:.2f} GiB; XE "
          f"{min(xe_ms):.1f} ms/step, SCST generate {min(gen_ms):.1f} ms, update "
          f"{min(upd_ms):.1f} ms (best of 2 each on the stream, the first includes warm-up)  "
          f"[{card}]", flush=True)
    if not all(counts.values()):
        fail(f"trainer: a kernel of the path was never launched: {counts}")
    for k, n in counts.items():
        RESULTS[k]["launches_trainer"] = n
    RESULTS["trainer"] = {"xe_ms": xe_ms, "generate_ms": gen_ms, "update_ms": upd_ms,
                          "xe_host_ms": xe_host, "generate_host_ms": gen_host,
                          "update_host_ms": upd_host, "generate_ahead_ms": ahead_ms,
                          "xe_epoch_s": xe_s, "sc_epoch_s": sc_s, "xe": xe_res, "sc": sc_res,
                          "eval_s_per_batch": avg_s, "eval_batch": EVAL_BATCH,
                          "sc_batch": SC_BATCH, "scores": scores, "peak_gib": peak,
                          "launches": counts, "checkpoint_mib": size_mb,
                          "checkpoint_loss_rel_diff": rel}


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
    saved, saved_adam = torch.Tensor.float, adam_ops.adam_update
    torch.Tensor.float = lambda self, *a, **k: self.double()
    # K12 takes f32 leaves only: this arm's float64 parameters step through its plain version
    adam_ops.adam_update = lambda *a, table=None, **k: adam_ops.adam_update_plain(*a, **k)
    try:
        with plain_arm():
            yield
    finally:
        torch.Tensor.float, adam_ops.adam_update = saved, saved_adam


def parity_arm(arm: str, batch: int, config=None):
    """One fp32 XE step, dropouts off, from the seed's weights and batch,
    through the kernels ("kernel"), the plain versions ("plain") or the plain
    versions in float64 ("float64") -> (loss, {name: gradient}, {name:
    (update, learning rate or None, the parameter's max before)}).  ``config``:
    the caption config (default ``default_caption_config()``)."""
    config = (config or default_caption_config()).copy()
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
    # the optimizer is no part of an arm: every arm's update goes through K12
    launched = sum(n for k, n in train_launches().items() if k != "K12")
    if (arm == "kernel") != (launched > 0):
        fail(f"training parity: the {arm} arm launched {launched} kernels")
    lrs = {id(p): g["lr"] for g in state.optimizer.param_groups for p in g["params"]}
    loss = float(metrics["loss"])
    print(f"[train parity] {arm} arm: loss {loss:.9f}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB", flush=True)
    return (loss, {n: p.grad for n, p in model.named_parameters()},
            {n: (p.detach() - before[n], lrs.get(id(p)), before[n].abs().max().item())
             for n, p in model.named_parameters()})


def module_grad_errors(batch: int, config=None) -> dict[str, tuple[float, str]]:
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
    state, _, tbatch = training_setup(config or default_caption_config(), torch.float32, batch,
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


def median_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median host milliseconds of ``fn`` over ``reps`` calls, each waited for."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def check_launches(what: str, counts: dict, want: dict) -> None:
    """The launches of one path's run (counts set to 0 just before it)."""
    print(f"[decoders] {what}: launches {counts} (want {want})", flush=True)
    if counts != want:
        fail(f"{what}: kernel launch counts {counts} != {want}")


def free_card() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_decoders_and_entry_points(card: str) -> None:
    """The decoders and entry points at full width, random weights
    (seed 0), each path's kernel launches counted from 0 around its run:

    - the sequential and concat decoders, bf16, b8 384x640, beam 5, 20 steps
      with EOS off: ms a batch (median of 7), peak memory, the Swin and
      detector kernels as in phase_slice and K11 none; in fp32 the kernel
      path's captions against the plain path's (the near-tie rule); one bf16
      XE step at b16 each, launches as phase_train's;
    - greedy_search, b8 bf16, EOS off: K11 3 layers x 20 steps; fp32 tokens
      against the plain path's;
    - beam_search(return_all_probs=True), b8 bf16 with the config's EOS:
      [8, 1, 20, V], all 20 steps run, the default beam's sequences, and the
      extra memory;
    - make_ensemble_generator over two members (seeds 0 and 1), b8 bf16, EOS
      off: twice one model's launches; in fp32 a one-member ensemble's tokens
      equal make_caption_generator's;
    - the online and nocaps CLIs' caption loop (engine.evaluator
      .caption_batches) over two b16 batches of random uint8 arrays, half of
      them padded, in bf16, at the online bucket (640x640) and at the config's
      (384x640) that nocaps uses, the generator as the CLIs build it (the
      config's EOS);
    - tools.extract_features.collect_vis_features (the detector in bf16) over
      an in-memory loader of four b16 384x640 batches, then two freezing-mode
      XE steps at b64 (optimizer.batch_size x 4) on those float16 features:
      K12 once a step (the model group: the detector gets no gradient), no
      Swin or MSDA kernel.

    K1, K2, K3, K10a and K10b are held to their plain versions at b16 in the
    640x640 bucket, in fp32 and bf16, before its loop runs (in main)."""
    config = default_caption_config()
    m = config.model
    vocab, layers, bos = m.vocab_size, m.cap_generator.n_layers, m.bos_idx
    batch = 8
    samples = synthetic_batch(batch)
    rec: dict = {}

    def counts_of(fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, caption_launches()

    # -- the sequential and concat decoders ---------------------------------
    for name in ("sequential", "concat"):
        dconfig = default_caption_config().apply_overrides(
            [f"model.cap_generator.decoder_name={name}"])
        model = build_captioner(dconfig, device=DEV, dtype=torch.bfloat16, seed=0)
        gen = make_caption_generator(model, beam_size=BEAM, max_len=STEPS, bos_idx=bos,
                                     eos_idx=vocab)
        gen(samples, batch)
        torch.cuda.reset_peak_memory_stats()
        out, counts = counts_of(lambda: gen(samples, batch))
        check_launches(f"{name} b{batch} caption batch", counts, {**forward_launches(), "K11": 0})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = median_ms(lambda: gen(samples, batch))
        out = out.cpu()
        if tuple(out.shape) != (batch, STEPS) or out.min() < 0 or out.max() >= vocab:
            fail(f"{name}: bad tokens, shape {tuple(out.shape)}")
        print(f"[decoders] {name} b{batch} bf16 beam {BEAM} x {STEPS} steps at {HW[0]}x{HW[1]}: "
              f"{ms:.1f} ms/batch (median of {TIMED_REPS}), {batch / ms * 1e3:.2f} images/s, "
              f"peak {peak:.2f} GiB  [{card}]", flush=True)
        del model, gen
        model = build_captioner(dconfig, device=DEV, dtype=torch.float32, seed=0)
        _, res_k = beam_run(model, samples, batch, bos, vocab, return_margins=True)
        with plain_arm():
            _, res_p = beam_run(model, samples, batch, bos, vocab)
        same_tokens(f"{name} parity", res_k.sequences[:, 0], res_p.sequences[:, 0],
                    res_k.margins.cpu())
        del model, res_k, res_p
        free_card()
        state, step, tbatch = training_setup(dconfig, torch.bfloat16, TRAIN_BATCH)
        step(state, tbatch)                                 # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        metrics = step(state, tbatch)[1]
        loss = float(metrics["loss"])
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = train_launches()
        print(f"[decoders] {name} b{TRAIN_BATCH} bf16 XE step: loss {loss:.4f}, {step_ms:.1f} ms, "
              f"K11 {tail_ops.LAUNCHES['decode_tail']}  [{card}]", flush=True)
        check_launches(f"{name} b{TRAIN_BATCH} XE step", counts, train_want())
        if not np.isfinite(loss) or tail_ops.LAUNCHES["decode_tail"]:
            fail(f"{name} XE step: loss {loss}, K11 launches {tail_ops.LAUNCHES['decode_tail']}")
        rec[name] = {"ms": ms, "peak_gib": peak, "xe_loss": loss, "xe_ms": step_ms,
                     "launches": counts}
        del state, step, tbatch, metrics
        free_card()

    # -- greedy, all-probs and the ensemble (the parallel decoder) ------------
    model = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0)

    @torch.inference_mode()
    def greedy(mdl):
        vis = mdl.compute_vis(samples)
        kv = mdl.precompute_vis_kv(vis)
        return greedy_search(
            lambda tok, t, v, c: mdl.decode_step(tok, t, v, c, vis_kv=kv, vis_fold=1),
            mdl.init_cache(batch, STEPS), vis, batch, STEPS, bos, vocab)

    greedy(model)
    (seq, lp), counts = counts_of(lambda: greedy(model))
    check_launches(f"greedy b{batch}", counts, {**forward_launches(), "K11": layers * STEPS})
    ms = median_ms(lambda: greedy(model))
    print(f"[decoders] greedy b{batch} bf16 x {STEPS} steps: {ms:.1f} ms/batch (median of "
          f"{TIMED_REPS})  [{card}]", flush=True)
    if tuple(seq.shape) != (batch, STEPS) or not torch.isfinite(lp).all():
        fail(f"greedy: sequences {tuple(seq.shape)}, log-probs finite "
             f"{bool(torch.isfinite(lp).all())}")
    rec["greedy"] = {"ms": ms, "launches": counts}

    def peak_run(**kw):
        """(beam_run's result, launches, peak bytes above what was allocated
        before), after a warm-up call."""
        beam_run(model, samples, batch, bos, m.eos_idx, **kw)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (_, res), n = counts_of(lambda: beam_run(model, samples, batch, bos, m.eos_idx, **kw))
        return res, n, torch.cuda.max_memory_allocated() - before

    base, counts_base, peak0 = peak_run()
    allp, counts, peak1 = peak_run(return_all_probs=True)
    extra = (peak1 - peak0) / 2 ** 20
    alp = allp.all_log_probs
    print(f"[decoders] beam {BEAM} b{batch} bf16 return_all_probs with EOS {m.eos_idx}: "
          f"all_log_probs {tuple(alp.shape)}, K11 {counts['K11']} (the default beam "
          f"{counts_base['K11']}), peak memory above the resident {peak1 / 2 ** 20:.1f} MiB, "
          f"the default beam's {peak0 / 2 ** 20:.1f} MiB ({extra:+.1f} MiB)  [{card}]",
          flush=True)
    if tuple(alp.shape) != (batch, 1, STEPS, vocab) or not torch.isfinite(alp).all():
        fail(f"return_all_probs: all_log_probs {tuple(alp.shape)}")
    if not torch.equal(allp.sequences, base.sequences):
        fail("return_all_probs: its sequences differ from the default beam's")
    if counts["K11"] != layers * STEPS:
        fail(f"return_all_probs: K11 launched {counts['K11']} times: the search stopped early")
    rec["all_probs"] = {"shape": list(alp.shape), "extra_peak_mib": extra,
                        "peak_mib": peak1 / 2 ** 20, "default_peak_mib": peak0 / 2 ** 20,
                        "k11_default": counts_base["K11"], "k11_all_probs": counts["K11"]}
    del base, allp, alp

    other = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=1)
    ens = make_ensemble_generator([model, other], beam_size=BEAM, max_len=STEPS, bos_idx=bos,
                                  eos_idx=vocab)
    ens(samples, batch)
    res, counts = counts_of(lambda: ens(samples, batch))
    check_launches(f"ensemble of 2, b{batch}", counts,
                   {**forward_launches(2), "K11": 2 * layers * STEPS})
    ms = median_ms(lambda: ens(samples, batch))
    print(f"[decoders] ensemble of 2 b{batch} bf16 beam {BEAM} x {STEPS}: {ms:.1f} ms/batch "
          f"(median of {TIMED_REPS})  [{card}]", flush=True)
    if tuple(res.sequences.shape) != (batch, 1, STEPS) or not torch.isfinite(res.scores).all():
        fail(f"ensemble: sequences {tuple(res.sequences.shape)}")
    rec["ensemble"] = {"ms": ms, "launches": counts}
    del other, ens, res
    free_card()

    # fp32: greedy against the plain path; a one-member ensemble against the
    # caption generator
    model32 = build_captioner(config, device=DEV, dtype=torch.float32, seed=0)
    seq_k = greedy(model32)[0]
    with plain_arm():
        seq_p = greedy(model32)[0]
    margins = beam_run(model32, samples, batch, bos, vocab, beam=1, return_margins=True)[1].margins
    same_tokens("greedy parity", seq_k, seq_p, margins.cpu())
    kw = dict(beam_size=BEAM, max_len=STEPS, bos_idx=bos, eos_idx=vocab)
    one = make_ensemble_generator([model32], **kw)(samples, batch).sequences[:, 0]
    ref = make_caption_generator(model32, **kw)(samples, batch)
    print(f"[decoders] fp32 one-member ensemble tokens equal make_caption_generator's: "
          f"{bool(torch.equal(one, ref))}", flush=True)
    if not torch.equal(one, ref):
        fail("a one-member ensemble's tokens differ from make_caption_generator's")
    del model32
    free_card()

    # -- the online and nocaps caption loops ----------------------------------
    text_field = synthetic_text_field(vocab)
    gen = make_caption_generator(model, beam_size=m.beam_size, max_len=m.beam_len, bos_idx=bos,
                                 eos_idx=m.eos_idx)
    nocaps_hw = tuple(config.dataset.transform_cfg.size)
    for cli, hw in (("online", ONLINE_BUCKET), ("nocaps", nocaps_hw)):
        batches = [(on_host(synthetic_batch(ONLINE_BATCH, 20 + j, hw)),
                    list(range(j * ONLINE_BATCH, (j + 1) * ONLINE_BATCH))) for j in range(2)]
        caption_batches(gen, batches[:1], text_field, device=DEV)     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results, counts = counts_of(lambda: caption_batches(gen, batches, text_field, device=DEV))
        per_batch = (time.perf_counter() - t0) * 1e3 / len(batches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = forward_launches(2)
        print(f"[decoders] {cli} loop: 2 batches of {ONLINE_BATCH} at {hw[0]}x{hw[1]} bf16: "
              f"{per_batch:.1f} ms/batch, peak {peak:.2f} GiB, launches {counts} (Swin and "
              f"detector: {want})  [{card}]", flush=True)
        if {k: counts[k] for k in want} != want or not counts["K11"]:
            fail(f"{cli} loop: launches {counts}, want {want} and K11")
        if ([r["image_id"] for r in results] != list(range(2 * ONLINE_BATCH))
                or not all(isinstance(r["caption"], str) for r in results)):
            fail(f"{cli} loop: results {results[:2]}")
        rec[cli] = {"hw": list(hw), "ms_per_batch": per_batch, "peak_gib": peak,
                    "launches": counts}
    del gen, model
    free_card()

    # -- feature extraction, then the freezing mode's XE steps -----------------
    detector = build_detector(config, device=DEV, dtype=torch.bfloat16, seed=0)
    loader = [{"samples": on_host(synthetic_batch(TRAIN_BATCH, 30 + j)),
               "image_id": list(range(j * TRAIN_BATCH, (j + 1) * TRAIN_BATCH))} for j in range(4)]
    t0 = time.perf_counter()
    feats, counts = counts_of(lambda: collect_vis_features(detector, [loader], DEV))
    extract_s = time.perf_counter() - t0
    check_launches("collect_vis_features over 4 b16 batches", {
        k: counts[k] for k in ("K1", "K2", "K3", "K10a", "K10b")}, forward_launches(4))
    fb = 4 * TRAIN_BATCH
    shapes = {k: (v.shape, v.dtype) for k, v in feats.items()}
    print(f"[decoders] collect_vis_features: {extract_s:.2f} s for {fb} images, {shapes}  "
          f"[{card}]", flush=True)
    if (list(feats["image_ids"]) != list(range(fb)) or feats["gri_feat"].dtype != np.float16
            or feats["reg_feat"].shape != (fb, m.detector.num_queries, m.detector.d_model)
            or not all(np.isfinite(feats[k]).all() for k in ("gri_feat", "reg_feat"))):
        fail(f"collect_vis_features: {shapes}")
    del detector
    free_card()
    model = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0, train=True)
    opt = optim_lib.build_optimizer(
        model, model_lr=SCHED["init_lr"], backbone_lr=config.optimizer.xe_backbone_lr,
        beta_1=config.optimizer.beta_1, beta_2=config.optimizer.beta_2)
    state = xe_lib.TrainState(model, opt, global_steps=1,
                              generator=torch.Generator(device=DEV).manual_seed(0))
    step = xe_lib.make_xe_train_step(pad_idx=m.pad_idx, sched_cfg=SCHED)
    # the loader's batch as the hdf5 reader gives it: numpy, features float16
    fbatch = {"samples": {k: feats[k] for k in FEATURES},
              "captions": training_captions(fb, config).cpu().numpy()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        metrics = step(state, to_device(fbatch, DEV))[1]
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = train_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[decoders] freezing mode: 2 XE steps b{fb} bf16 on float16 features: losses "
          f"{losses}, {step_ms[0]:.1f} / {step_ms[1]:.1f} ms a step (the first warms up), peak "
          f"{peak:.2f} GiB, launches {counts}  [{card}]", flush=True)
    kernels = ("K1", "K2", "K3", "K4", "K5", "K6", "K10a", "K10b")
    if counts["K12"] != 2 or any(counts[k] for k in kernels) or not np.isfinite(losses).all():
        fail(f"freezing mode: launches {counts} (want K12 2, none of {kernels}), losses {losses}")
    if any(p.grad is not None for p in model.detector.parameters()):
        fail("freezing mode: a detector parameter got a gradient from cached features")
    rec["extract"] = {"seconds": extract_s, "images": fb}
    rec["freezing"] = {"batch": fb, "losses": losses, "step_ms": step_ms, "peak_gib": peak,
                       "launches": counts}
    RESULTS["decoders"] = rec
    del model, opt, state
    free_card()


def phase_train_parity(batch: int, config=None, label: str = "") -> None:
    """fp32, dropouts and drop-path off, the training step's own batch: one
    XE step through the kernels, one through the plain versions, and one
    through the plain versions in float64, from the same weights and batch;
    the float64 step is the yardstick of both.  Then every module that holds
    a kernel with a backward alone on the same inputs, where nothing can flip
    and the bound is tight.  ``config`` / ``label``: another caption config
    (another Swin preset), its results under "train_parity <label>"."""
    (loss_k, grad_k, upd_k), (loss_p, grad_p, _), (loss_r, grad_r, _) = (
        parity_arm(arm, batch, config) for arm in ("kernel", "plain", "float64"))
    torch.cuda.empty_cache()
    rel_k, rel_p = abs(loss_k - loss_r) / abs(loss_r), abs(loss_p - loss_r) / abs(loss_r)
    print(f"[train parity] fp32 b{batch} {label} loss against float64: kernel rel err {rel_k:.3e}, "
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
    alone = module_grad_errors(batch, config)
    print(f"[train parity] each module alone on the same inputs and output gradient, kernels "
          f"against plain, worst gradient leaf (tol {SAME_INPUT_TOL:.0e}):")
    for group, (err, name) in alone.items():
        print(f"[train parity]   {group:<18} {err:.3e}  ({name})", flush=True)
        if not err <= SAME_INPUT_TOL:
            failures.append(f"{name} alone: gradient err {err:.3e} > {SAME_INPUT_TOL:.0e}")
    RESULTS["train_parity" + (f" {label}" if label else "")] = {
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


# ---------------------------------------------------------------------------
# detector pre-training at 832x1344
# ---------------------------------------------------------------------------
MAX_BOXES = 100      # dataset.max_boxes: the padded targets' width
DET_STEPS = 3        # timed training steps after the warm-up epoch
DET_PARITY_BATCH = 2


def detector_images(batch: int, offset: int = 0) -> ImageBatch:
    """uint8 images in the 832x1344 bucket from a seed, on the host; every
    other image smaller than the bucket."""
    rng = np.random.default_rng(3000 + BATCH_SEED + offset)
    imgs = np.zeros((batch, *DET_HW, 3), np.uint8)
    mask = np.ones((batch, *DET_HW), bool)
    for i in range(batch):
        h, w = DET_HW if i % 2 == 0 else (DET_HW[0] * 3 // 4, DET_HW[1] * 4 // 5)
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask[i, :h, :w] = False
    return ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask))


def detector_targets(batch: int, num_classes: int, offset: int = 0) -> dict:
    """Padded targets as ``datasets.pad_targets`` builds them: 0 to 20 boxes an
    image (the first image of every second batch has none), cxcywh in [0, 1]."""
    rng = np.random.default_rng(4000 + BATCH_SEED + offset)
    out = {"labels": np.zeros((batch, MAX_BOXES), np.int32),
           "boxes": np.zeros((batch, MAX_BOXES, 4), np.float32),
           "valid": np.zeros((batch, MAX_BOXES), bool)}
    for i in range(batch):
        n = 0 if (i == 0 and offset % 2) else int(rng.integers(1, min(20, MAX_BOXES) + 1))
        out["labels"][i, :n] = rng.integers(0, num_classes, n)
        out["boxes"][i, :n] = np.concatenate(
            [rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.03, 0.4, (n, 2))], 1)
        out["valid"][i, :n] = True
    return out


@torch.no_grad()
def perturb_norms(model, seed: int) -> None:
    """Add N(0, 0.1) from ``seed`` to every LayerNorm's and GroupNorm's scale
    and bias: with the initial zero biases a padded pixel is an all-zero row
    at every LayerNorm it meets, each of which multiplies its gradient by
    eps^-1/2 = 316."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
            mod.weight.add_(torch.randn(mod.weight.shape, generator=g, device=DEV) * 0.1)
            mod.bias.add_(torch.randn(mod.bias.shape, generator=g, device=DEV) * 0.1)


def detector_setup(dtype, *, dropouts: bool = True, use_checkpoint: bool = False, seed: int = 0,
                   backbone: str | None = None):
    """The detector trainer a user would build (``train_detector.main``'s
    recipe) at full width: the model in train() with f32 master parameters
    computing in ``dtype``, the whole Swin training, the criterion, the
    five-group AdamW (four groups hold parameters without the attribute head)
    and the train step.  The norms' scales and biases are perturbed from the
    seed: with the initial zero biases a padded pixel is an all-zero row at
    every LayerNorm it meets, each of which multiplies its gradient by
    eps^-1/2 = 316.  ``backbone``: a Swin preset other than the config's."""
    config = default_detection_config()
    config.model.use_checkpoint = use_checkpoint
    if backbone:
        config.model.backbone = backbone
    model, criterion = build_detection_model(config, dtype, device=DEV, seed=seed)
    perturb_norms(model, seed + 1)
    for mod in model.modules():
        if not dropouts and isinstance(mod, Dropout):
            mod.p = 0.0
        elif not dropouts and isinstance(mod, SwinBlock):
            mod.drop_path_rate = 0.0
    o = config.optimizer
    opt = optim_lib.build_detector_optimizer(
        model, lr=o.lr, lr_backbone=o.lr_backbone, sp_lr=o.sp_lr, weight_decay=o.weight_decay,
        sp_names=list(o.sp_names))
    state = xe_lib.TrainState(model, opt, global_steps=0,
                              generator=torch.Generator(device=DEV).manual_seed(seed))
    step = det_solver.make_detector_train_step(criterion, clip_max_norm=o.clip_max_norm)
    return config, state, criterion, step


def phase_detector(card: str, dtype, backbone: str | None = None, full: bool = True) -> None:
    """Detector pre-training at full width (``default_detection_config()``:
    Swin-B window 12 training whole, d512, 6 deformable layers, 150 queries,
    1849 classes, aux losses, box refinement), random weights from a seed, b4
    in the 832x1344 bucket, through the port's own ``Trainer.run_epoch`` over
    in-memory loaders with the CLI's hooks attached: a warm-up epoch of one
    step, then an epoch of DET_STEPS steps whose kernel launches are checked
    step by step; inside each epoch ``Valider.run_epoch`` -> ``postprocess`` ->
    ``CocoEvaluator`` over two batches in eval(); the checkpoint hook's
    ``detector_last`` restored into a freshly built model and optimizer, after
    which one more step from each must give the same loss.  ``backbone``:
    another Swin preset; ``full=False``: no validation and no restore, one
    profiled step instead."""
    import tempfile

    dn = ("fp32" if dtype == torch.float32 else "bf16") + (f" {backbone}" if backbone else "")
    config, state, criterion, step = detector_setup(dtype, backbone=backbone)
    model = state.model
    num_classes = config.model.detector.num_classes
    groups = [g["name"] for g in state.optimizer.param_groups]
    det_stages = preset_stages(backbone, DET_HW) if backbone else DET_STAGES
    blocks = sum(s[-1] for s in det_stages)
    bf = dtype == torch.bfloat16     # the GEMM, core and backward of the step's type
    gemms = 4 * blocks + len(det_stages)
    want_step = {"K1": 0, "K2": blocks, "K3": DET_LAYERS, "K4": blocks, "K5": blocks,
                 "K6": DET_LAYERS, "K10a": len(det_stages), "K10b": 1, "K12": len(groups),
                 "gemm_bf16": bf * gemms, "win_attn": bf * blocks, "win_attn_bwd": bf * blocks,
                 "gemm_f32": (1 - bf) * gemms, "win_attn_f32": (1 - bf) * blocks,
                 "win_attn_bwd_f32": (1 - bf) * blocks,
                 "lsa": 1,   # the matcher: every level and image in one grit_lsa launch
                 **dict.fromkeys(("K2 bwd", "gelu_bwd", "ln_rows_bwd"), blocks)}
    want_eval = {"K1": blocks, "K2": blocks, "K3": DET_LAYERS, "K4": 0, "K5": 0, "K6": 0,
                 "K10a": len(det_stages), "K10b": 1, "K12": 0,
                 "gemm_bf16": bf * gemms, "win_attn": bf * blocks, "win_attn_bwd": 0,
                 "gemm_f32": (1 - bf) * gemms, "win_attn_f32": (1 - bf) * blocks,
                 "win_attn_bwd_f32": 0, "lsa": 0,
                 **dict.fromkeys(("K2 bwd", "gelu_bwd", "ln_rows_bwd"), 0)}

    def launches() -> dict:
        return {**train_launches(), **f32_launches(), "lsa": lsa_ops.LAUNCHES["lsa"],
                **mlp_bwd_launches(dtype)}

    def train_batch(offset: int) -> dict:
        return {"samples": detector_images(DET_BATCH, offset),
                "targets": detector_targets(DET_BATCH, num_classes, offset)}

    rng = np.random.default_rng(5000 + BATCH_SEED)
    valid_loader, gt = [], {}
    for j in range(2):
        ids = list(range(j * DET_BATCH, (j + 1) * DET_BATCH))
        valid_loader.append({"samples": detector_images(DET_BATCH, 10 + j),
                             "orig_sizes": np.tile([[480, 640]], (DET_BATCH, 1)),
                             "image_id": ids})
        for i in ids:
            xy = rng.uniform(0, 300, (3, 2))
            gt[i] = {"boxes": np.concatenate([xy, xy + rng.uniform(20, 200, (3, 2))], 1),
                     "labels": rng.integers(0, num_classes, 3)}

    spans, per_step, per_eval, eval_s, metrics_seen = [], [], [], [], []

    def counted_step(*args, **kw):
        before = launches()
        out = timed(*args, **kw)
        after = launches()
        per_step.append({k: after[k] - before[k] for k in after})
        metrics_seen.append(out[1])
        return out

    timed = on_stream(step, spans)

    class CountEval(det_hooks.Hook):
        """Kernel launches of one validation epoch (attached to the valider)."""

        def before_epoch(self, solver):
            self.before = launches()
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def after_epoch(self, solver):
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - self.t0)
            after = launches()
            per_eval.append({k: after[k] - self.before[k] for k in after})

    with tempfile.TemporaryDirectory() as workdir:
        valider = det_solver.Valider(lambda: trainer.state.model, valid_loader,
                                     lambda: CocoEvaluator(gt), device=DEV, hooks=[CountEval()])
        decay = float(config.optimizer.decay_rate)
        hooks = [det_hooks.EpochLRHook([m - 1 for m in config.optimizer.lr_drop_epochs], decay),
                 det_hooks.EpochLRHook([m - 1 for m in config.optimizer.sp_lr_drop_epochs],
                                       decay, attr="sp_epoch_lr_scale"),
                 det_hooks.ProgressHook(),
                 det_hooks.TextLoggingHook(os.path.join(workdir, "detector_log.txt")),
                 det_hooks.ScalarWriterHook(os.path.join(workdir, "scalars.jsonl")),
                 # saves at the end of the second epoch: detector_epoch_1 and detector_last
                 det_hooks.CheckpointHook(workdir, every=2)]
        trainer = det_solver.Trainer(counted_step, state, [train_batch(0)], device=DEV, seed=0,
                                     hooks=hooks, validers=[valider] if full else [])
        trainer.run_epoch(0)                         # warm-up: one step and a validation
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        del spans[:], per_step[:], per_eval[:], metrics_seen[:]
        trainer.dataloader = [train_batch(1 + j) for j in range(DET_STEPS)]
        t0 = time.perf_counter()
        trainer.run_epoch(1)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = launches()
        step_ms, host_ms = span_ms(spans)
        losses = [{k: float(v) for k, v in m.items()} for m in metrics_seen]
        size_mb = os.path.getsize(os.path.join(workdir, "checkpoints", "detector_last",
                                               ckpt_lib.STATE_FILE)) / 2 ** 20
        saved = sorted(os.listdir(os.path.join(workdir, "checkpoints")))
        if full:
            _, state2, _, _ = detector_setup(dtype, seed=1)
            restored = ckpt_lib.restore_checkpoint(workdir, "detector_last")
            ckpt_lib.load_train_state(state2, restored)

    print(f"[detector {dn}] optimizer groups {groups}; launches of each of {DET_STEPS} training "
          f"steps: {per_step[0]} (want {want_step})" + (
              f"; of a validation epoch of 2 batches: {per_eval[0]} (want 2 x {want_eval})"
              if full else ""))
    if any(c != want_step for c in per_step) or len(per_step) != DET_STEPS:
        fail(f"detector {dn}: launches per training step {per_step} != {want_step}")
    for i, m in enumerate(losses):
        print(f"[detector {dn}] step {i}: " + " ".join(f"{k} {v:.4f}" for k, v in m.items()))
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        fail(f"detector {dn}: non-finite training metrics {losses}")
    for name, prm in model.named_parameters():
        if prm.dtype != torch.float32 or not torch.isfinite(prm).all():
            fail(f"detector {dn}: parameter {name} is {prm.dtype} or non-finite")
    if saved != ["detector_epoch_1", "detector_last"]:
        fail(f"detector {dn}: checkpoints {saved}")
    if not full:
        nxt = train_batch(9)
        images = nxt["samples"].to(DEV)
        targets = {k: torch.from_numpy(v).to(DEV) for k, v in nxt["targets"].items()}
        targets["labels"] = targets["labels"].long()
        step(state, images, targets)
        torch.cuda.synchronize()
        prof = profile_run(lambda: step(state, images, targets),
                           f"b{DET_BATCH} {dn} detector training step at {DET_HW[0]}x{DET_HW[1]} "
                           f"[{card}]", f"profile_detector_{dn.replace(' ', '_')}.txt", 6)
        med = sorted(step_ms)[len(step_ms) // 2]
        print(f"[detector {dn}] b{DET_BATCH} {dn} detector step at {DET_HW[0]}x{DET_HW[1]}, the "
              f"whole Swin training: {med:.1f} ms/step (median of {step_ms} on the stream), "
              f"peak {peak:.2f} GiB; profiled step: device busy {prof['busy_ms']:.1f} ms, idle "
              f"share {prof['idle_share']:.3f}  [{card}]", flush=True)
        RESULTS[f"detector_{dn}"] = {
            "batch": DET_BATCH, "step_ms": step_ms, "host_ms": host_ms, "peak_gib": peak,
            "launches_per_step": per_step[0], "losses": losses, "profile": prof}
        return
    if per_eval != [{k: 2 * v for k, v in want_eval.items()}]:
        fail(f"detector {dn}: launches of the validation epoch {per_eval} != 2 x {want_eval}")
    res = trainer.epoch_results
    print(f"[detector {dn}] Valider -> postprocess -> CocoEvaluator over 2 batches of "
          f"{DET_BATCH} in eval(): {eval_s[-1] / 2 * 1e3:.1f} ms/batch, {json.dumps(res)}")
    if "mAP" not in res or not np.isfinite(list(res.values())).all():
        fail(f"detector {dn}: validation summary {res}")
    if restored["epoch"] != 1:
        fail(f"detector {dn}: restored epoch {restored['epoch']}")

    # one more step from the trained state and from the restored one
    nxt = train_batch(9)
    nxt = {"samples": nxt["samples"].to(DEV),
           "targets": {k: torch.from_numpy(v).to(DEV) for k, v in nxt["targets"].items()}}
    nxt["targets"]["labels"] = nxt["targets"]["labels"].long()
    after = []
    for st in (state, state2):
        st.generator.manual_seed(77)
        after.append(float(step(st, nxt["samples"], nxt["targets"])[1]["loss"]))
    rel = abs(after[0] - after[1]) / max(abs(after[0]), 1e-30)
    print(f"[detector {dn}] detector_last ({size_mb:.0f} MiB) restored into a fresh model and "
          f"optimizer: next loss {after[0]:.9f} vs {after[1]:.9f}, rel diff {rel:.3e} (tol 1e-06), "
          f"step counter {state2.global_steps}")
    if not np.isfinite(after).all() or rel > 1e-6 or state2.global_steps != state.global_steps:
        fail(f"detector {dn}: checkpoint round trip: losses {after}")
    del state2
    device_launches = count_launches(lambda: step(state, nxt["samples"], nxt["targets"]))
    matcher = detector_matcher_paths(dn, card, state, criterion, step, nxt)
    # K12 on the detector's own leaves: one update of every group, on the last step's gradients
    n_el = sum(p.numel() for g in state.optimizer.param_groups for p in g["params"])
    adam_ms = cuda_ms(state.optimizer.step)
    print(f"[detector {dn}] K12, one update of {n_el} elements in {len(groups)} launches: "
          f"{adam_ms:.3f} ms, bound {28.0 * n_el / PEAK_BYTES * 1e3:.3f} ms (28 bytes an element)")
    med = sorted(step_ms)[len(step_ms) // 2]
    print(f"[detector {dn}] b{DET_BATCH} {dn} detector step at {DET_HW[0]}x{DET_HW[1]}, the whole "
          f"Swin training: {med:.1f} ms/step (median of {step_ms} on the stream; {host_ms} ms of "
          f"the host in the call), {DET_BATCH / med * 1e3:.2f} images/s, {device_launches} device "
          f"kernels a step, peak {peak:.2f} GiB; the epoch of {DET_STEPS} steps and a validation "
          f"of 2 batches {epoch_s:.2f} s  [{card}]", flush=True)
    # the detector row of each kernel is of the step in its own type
    for k, n in per_step[0].items():
        if bf != (k in f32_launches()):
            RESULTS.setdefault(k, {})["launches_detector"] = n
    RESULTS[f"detector_{dn}"] = {
        "batch": DET_BATCH, "step_ms": step_ms, "host_ms": host_ms, "epoch_s": epoch_s,
        "images_per_s": DET_BATCH / med * 1e3, "device_launches": device_launches,
        "peak_gib": peak, "launches_per_step": per_step[0], "launches_eval": per_eval[0],
        "eval_s_per_batch": eval_s[-1] / 2, "adam_ms": adam_ms, "adam_elements": n_el,
        "adam_bound_ms": 28.0 * n_el / PEAK_BYTES * 1e3, "matcher": matcher,
        "losses": losses, "valid": res, "checkpoint_mib": size_mb,
        "checkpoint_loss_rel_diff": rel, "groups": groups, "phase_launches": counts}


NATIVE_IMAGES = 5000   # the synthetic corpus of the metric check (COCO's val split's size)
NATIVE_WORDS = ("a the A man's dog doesn't run, very fast. two dogs -- playing in 3 parks... "
                "it's red; 1,000 trees! (big) cat t-shirt on: under over with near far a an "
                "of to and person people car bus tree sky water grass table").split()


def phase_native_metrics() -> None:
    """The native metric library built here with g++ from
    grit_tpu_torch/native/fastmetrics.cpp; its PTB tokenizer against the
    pure-Python one (string for string) and its CIDEr-D against the
    pure-Python scorer (1e-10 relative), with and without a precomputed
    corpus, on NATIVE_IMAGES synthetic images of five references and one
    candidate each; both timed on the host."""
    from grit_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.get_lib()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(7000 + BATCH_SEED)

    def caption():
        return " ".join(NATIVE_WORDS[i] for i in rng.integers(0, len(NATIVE_WORDS),
                                                                rng.integers(4, 16)))

    gts = {i: [caption() for _ in range(5)] for i in range(NATIVE_IMAGES)}
    res = {i: [caption()] for i in range(NATIVE_IMAGES)}
    timed = {}

    def clock(name, fn):
        t0 = time.perf_counter()
        out = fn()
        timed[name] = (time.perf_counter() - t0) * 1e3
        return out

    tok = clock("tokenize native", lambda: PTBTokenizer.tokenize(gts))
    tok_py = clock("tokenize python", lambda: PTBTokenizer.tokenize(gts, use_native=False))
    if tok != tok_py:
        fail("native metrics: the native tokenizer's tokens differ from the Python rules'")
    cand = PTBTokenizer.tokenize(res)
    worst = 0.0
    for mode, corpus in (("per call", None), ("precomputed", tok)):
        a = clock(f"CIDEr-D {mode} native", lambda: Cider(corpus).compute_score(tok, cand))
        b = clock(f"CIDEr-D {mode} python",
                  lambda: Cider(corpus, use_native=False).compute_score(tok, cand))
        worst = max(worst, abs(a[0] - b[0]) / abs(b[0]),
                    float(np.max(np.abs(a[1] - b[1]) / np.maximum(np.abs(b[1]), 1e-30))))
    print(f"[native metrics] {Path(lib._name).name} built in {build_s:.1f} s; {NATIVE_IMAGES} "
          f"images x 5 references: tokens equal; CIDEr-D max rel err {worst:.1e} (tol 1e-10); "
          + ", ".join(f"{k} {v:.0f} ms" for k, v in timed.items()) + " (host)", flush=True)
    if worst > 1e-10:
        fail(f"native metrics: CIDEr-D differs from the Python scorer by {worst:.3e}")
    RESULTS["native_metrics"] = {"build_s": build_s, "images": NATIVE_IMAGES, "max_rel_err": worst,
                                 "host_ms": timed}


TOOL_TIMEOUT = 420   # seconds a tool's process may take; past it it is killed


def run_tool(name: str, args: list[str], expect: list[str]) -> str:
    """``python -m grit_tpu_torch.tools.<name> args`` from the checkout's root,
    waited for (killed past TOOL_TIMEOUT); fails unless it exits with 0 and
    prints every line fragment in ``expect`` -> its output."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", f"grit_tpu_torch.tools.{name}", *args],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=TOOL_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"tools: {name} ran past {TOOL_TIMEOUT} s")
    out = proc.stdout
    missing = [e for e in expect if e not in out]
    lines = [ln for ln in out.splitlines() if ln.strip()]
    print(f"[tools] {name} {' '.join(args)}: rc {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s\n[tools]   " + "\n[tools]   ".join(lines[-12:]),
          flush=True)
    if proc.returncode != 0 or missing:
        fail(f"tools: {name} exited with {proc.returncode}, missing {missing}:\n"
             f"{proc.stderr[-3000:]}")
    return out


def phase_tools() -> None:
    """The four measuring tools, briefly, at full width on this card:
    bench_train (XE at b16 and SCST at b8, 2 steps each after a warm-up),
    profile_eval at b8 with a trace of the batch, agg_trace on that trace, and
    bench_epoch over a synthetic COCO of 32 images in a temporary directory
    (one XE and one SCST epoch of the training CLI, the loader alone).  The
    tools' processes load the library this one built."""
    import tempfile

    free_card()
    run_tool("bench_train", ["--phase", "both", "--iters", "2", "--batches", str(TRAIN_BATCH),
                             "--sc-batches", str(SC_BATCH)],
             [f"[XE fs=2 b={TRAIN_BATCH}] first step", f"[SC beam={BEAM} fs=2 b={SC_BATCH}]",
              "median step", "peak"])
    with tempfile.TemporaryDirectory() as work:
        trace = os.path.join(work, "trace")
        run_tool("profile_eval", ["8", "--trace", trace],
                 ["attribution at batch 8", "FULL generate", "trace written to"])
        run_tool("agg_trace", [trace, "--top", "15", "--by-class"],
                 ["device events", "idle share", "-- by class (ms) --"])
        run_tool("bench_epoch", ["--root", os.path.join(work, "coco"), "--images", "32",
                                 "--val-images", "16"],
                 ["loader-only sustained", "TOTAL recipe wall", "rc=0"])


DET_MATCH_STEPS = 3   # detector steps a turn in each solver's timing


def stacked_cost(criterion, outputs: dict, targets: dict) -> torch.Tensor:
    """The matching costs [levels, B, Q, G] of the final and every aux level,
    as ``criterion.match_levels`` computes them."""
    aux = outputs["aux_outputs"]
    return det_losses.matching_cost(
        torch.stack([outputs["pred_logits"]] + [a["pred_logits"] for a in aux]),
        torch.stack([outputs["pred_boxes"]] + [a["pred_boxes"] for a in aux]),
        targets["labels"], targets["boxes"], targets["valid"],
        **{k: v for k, v in criterion.cost.items() if k != "impl"})


def assignment_totals(cost: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """[levels, B]: the cost of an assignment [levels, B, G], image by image."""
    picked = torch.gather(cost, 2, assign.clamp(min=0)[:, :, None, :])[:, :, 0, :]
    return torch.where(assign >= 0, picked, 0.0).sum(-1)


def detector_matcher_paths(dn: str, card: str, state, criterion, step, batch: dict) -> dict:
    """The detector step's matching on the card against the host path, on
    ``batch``: the criterion alone under ``torch.cuda.set_sync_debug_mode(
    "error")`` (no copy to the host; one grit_lsa launch); the two solvers'
    assignments on the step's own costs (equal, but where the host's costs
    the device's optimum at most ASSIGN_MARGIN more: a near-tie); grit_lsa on
    those problems (``check_lsa``); then the step under ``match_impl="host"``
    and ``"device"`` in turns (host, device, device, host), DET_MATCH_STEPS
    steps issued back to back a turn and waited for once, and one profiled
    step of each (device busy, idle share)."""
    images, targets = batch["samples"], batch["targets"]
    saved = criterion.cost["impl"]
    with torch.no_grad():
        outputs = state.model(images, training=True)
    torch.cuda.synchronize()
    before = lsa_ops.LAUNCHES["lsa"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        criterion(outputs, targets)
    except RuntimeError as exc:
        fail(f"detector {dn}: the criterion waited for the device: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    crit_launches = lsa_ops.LAUNCHES["lsa"] - before
    if crit_launches != 1:
        fail(f"detector {dn}: the criterion launched grit_lsa {crit_launches} times, not once")
    assigns = {}
    for impl in ("host", "device"):
        criterion.cost["impl"] = impl
        assigns[impl] = criterion.match_levels(outputs, targets)
    criterion.cost["impl"] = saved
    cost = stacked_cost(criterion, outputs, targets)
    differ = int((assigns["host"] != assigns["device"]).sum())
    gap = float((assignment_totals(cost, assigns["host"])
                 - assignment_totals(cost, assigns["device"])).abs().max())
    print(f"[detector {dn}] the criterion alone under set_sync_debug_mode('error'): no wait "
          f"for the device, {crit_launches} grit_lsa launch; device and host assignments on the "
          f"step's own costs differ at {differ} of {int((assigns['host'] >= 0).sum())} boxes "
          f"(totals differ by at most {gap:.3e})", flush=True)
    if differ and not gap <= ASSIGN_MARGIN:
        fail(f"detector {dn}: the device solver's assignments differ from the host's beyond a "
             f"near-tie ({gap:.3e})")
    levels, b, q, g = cost.shape
    row = check_lsa(f"{dn} step's costs [{levels * b}, {q}, {g}]", cost.reshape(-1, q, g),
                    targets["valid"].bool().sum(-1).repeat(levels))
    del outputs
    ms = {"host": [], "device": []}
    for impl in ("host", "device", "device", "host"):
        criterion.cost["impl"] = impl
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DET_MATCH_STEPS):
            step(state, images, targets)
        torch.cuda.synchronize()
        ms[impl].append((time.perf_counter() - t0) * 1e3 / DET_MATCH_STEPS)
    prof = {}
    for impl in ("host", "device"):
        criterion.cost["impl"] = impl
        prof[impl] = profile_run(lambda: step(state, images, targets),
                                 f"b{DET_BATCH} {dn} detector step, match_impl={impl} [{card}]",
                                 f"profile_detector_{dn.replace(' ', '_')}_match_{impl}.txt", 1,
                                 kernel="lsa_kernel")
    criterion.cost["impl"] = saved
    print(f"[detector {dn}] grit_lsa in the profiled step under match_impl=device: "
          f"{prof['device']['kernel_ms']:.3f} ms device, {prof['device']['kernel_launches']} "
          f"launch  [{card}]", flush=True)
    for impl in ("host", "device"):
        print(f"[detector {dn}] match_impl={impl}: {[round(t, 1) for t in ms[impl]]} ms/step "
              f"({DET_MATCH_STEPS} steps a turn, issued back to back); profiled step busy "
              f"{prof[impl]['busy_ms']:.1f} ms, idle share {prof[impl]['idle_share']:.3f}, "
              f"wall {prof[impl]['wall_ms']:.1f} ms  [{card}]", flush=True)
    return {"lsa": row, "assign_differ": differ, "assign_gap": gap,
            "ms_per_step": ms, "profile": prof}


DET_PARITY_GROUPS = (("heads", "det_module.class_embed."), ("heads", "det_module.bbox_embed."),
                     ("deformable decoder", "det_module."), ("input_proj", "input_proj."),
                     ("swin", "backbone."))
# an assignment found on one arm's costs may differ from another arm's at a
# near-tie: the yardstick's assignment may cost an fp32 arm at most this much
# more, summed over an image's boxes, than the arm's own optimum
ASSIGN_MARGIN = 1e-3
# The detector's losses read its boxes directly, at all seven levels, and the
# random-weight decoder multiplies a forward rounding difference by 2-4.5 at
# each of its six refinements (see REG_FEAT_TOL): the plain fp32 path itself
# stands 1.5e-5 (total) to 1.1e-4 (loss_bbox) from float64, the kernel path
# 1.1e-5 to 6.5e-5 (PERF.md).  The offsets of the last layers' sampling
# locations take the flips of every floor() downstream of six refinements:
# both fp32 paths read 0.35 of the leaf's max there, alike; a wrong gradient
# reads 1 or more
DET_LOSS_TOL, DET_FLIP_TOL = 1e-3, 0.5


def detector_parity_arm(arm: str, batch: int, assigns=None):
    """One fp32 detector step, dropouts and drop-path off, from the seed's
    weights and batch, through the kernels ("kernel"), the plain versions
    ("plain") or the plain versions in float64 with the Swin blocks
    checkpointed ("float64"), with the Hungarian assignments ``assigns`` (None:
    the arm's own) -> (metrics, the assignments used, how much more ``assigns``
    costs than the arm's own optimum, {name: gradient}, {name: (update, lr,
    weight decay, the parameter before)}, {"cost": the arm's matching costs
    [levels, B, Q, G], "n_valid": [B]}).  The float64 arm, the yardstick,
    matches on the host (scipy in float64); the others as the config says
    (the kernel arm through grit_lsa, the plain arm through its plain
    version)."""
    _, state, criterion, step = detector_setup(torch.float32, dropouts=False,
                                               use_checkpoint=arm == "float64")
    if arm == "float64":
        criterion.cost["impl"] = "host"
    model = state.model
    if arm == "float64":
        to_compute_dtype(model.double(), torch.float64, master_f32=True)
    images = detector_images(batch).to(DEV)
    targets = {k: torch.from_numpy(v).to(DEV)
               for k, v in detector_targets(batch, criterion.num_classes).items()}
    targets["labels"] = targets["labels"].long()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with {"kernel": contextlib.nullcontext, "plain": plain_arm, "float64": float64_arm}[arm]():
        with torch.no_grad():
            outputs = model(images, training=True)
            own = criterion.match_levels(outputs, targets)
            cost = stacked_cost(criterion, outputs, targets)
            gap = 0.0
            if assigns is not None:
                gap = float((assignment_totals(cost, assigns) - assignment_totals(cost, own)).max())
            del outputs
        reset_launches()
        _, metrics = step(state, images, targets, assigns=own if assigns is None else assigns)
    launched = sum(n for k, n in train_launches().items() if k != "K12")
    if (arm == "kernel") != (launched > 0):
        fail(f"detector parity: the {arm} arm launched {launched} kernels")
    group = {id(p): g for g in state.optimizer.param_groups for p in g["params"]}
    metrics = {k: float(v) for k, v in metrics.items()}
    print(f"[detector parity] {arm} arm: loss {metrics['loss']:.9f}, grad norm "
          f"{metrics['grad_norm']:.6e}, {int((own >= 0).sum())} matched boxes over "
          f"{own.shape[0]} levels, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB",
          flush=True)
    return (metrics, own, gap, {n: p.grad for n, p in model.named_parameters()},
            {n: (p.detach() - before[n], group[id(p)]["lr"], group[id(p)]["weight_decay"],
                 before[n]) for n, p in model.named_parameters()},
            {"cost": cost, "n_valid": targets["valid"].bool().sum(-1)})


def phase_detector_parity(batch: int) -> None:
    """fp32, dropouts and drop-path off, b2 at 832x1344 (the float64 arm's
    memory): one detector step through the plain versions in float64 (Swin
    blocks checkpointed), whose Hungarian assignments are then fed to one step
    through the kernels and one through the plain versions in fp32, from the
    same weights and batch.  Held: each fp32 arm's own assignments (equal to
    float64's, or differing only where float64's costs the arm at most
    ASSIGN_MARGIN more than its own optimum), the total and every named loss
    (DET_LOSS_TOL), the gradient norm and every clipped gradient leaf by module
    group (DET_FLIP_TOL: a ReLU gate or a sampling floor may flip, as in the
    caption training parity), and the kernel path's update against AdamW's
    first step on its own gradient (UPDATE_TOL of the group's learning rate)."""
    m_r, assign_r, _, grad_r, _, yard = detector_parity_arm("float64", batch)
    # the kernel on the yardstick's own costs (cast to f32, as the solver
    # takes them) against the host solver's float64 assignments
    levels, b, q, g = yard["cost"].shape
    on_f64 = lsa_ops.linear_sum_assignment(yard["cost"].reshape(-1, q, g),
                                           yard["n_valid"].repeat(levels)).reshape(levels, b, g)
    on_f64 = torch.where(assign_r >= 0, on_f64, -1)
    differ_f64 = int((on_f64 != assign_r).sum())
    gap_f64 = float((assignment_totals(yard["cost"], on_f64)
                     - assignment_totals(yard["cost"], assign_r)).max())
    print(f"[detector parity] grit_lsa on the float64 arm's costs: {differ_f64} of "
          f"{int((assign_r >= 0).sum())} assignments differ from the host solver's; it costs at "
          f"most {gap_f64:.3e} more (margin {ASSIGN_MARGIN:.0e})", flush=True)
    del yard
    torch.cuda.empty_cache()
    m_k, assign_k, gap_k, grad_k, upd_k, _ = detector_parity_arm("kernel", batch, assign_r)
    m_p, assign_p, gap_p, grad_p, _, _ = detector_parity_arm("plain", batch, assign_r)
    torch.cuda.empty_cache()
    failures = []
    if differ_f64 and not gap_f64 <= ASSIGN_MARGIN:
        failures.append(f"grit_lsa's assignments on the float64 costs differ from the host "
                        f"solver's beyond a near-tie ({gap_f64:.3e})")
    for arm, own, gap in (("kernel", assign_k, gap_k), ("plain", assign_p, gap_p)):
        differ = int((own != assign_r).sum())
        print(f"[detector parity] {arm} arm's own assignments differ from float64's at {differ} "
              f"of {int((assign_r >= 0).sum())} boxes; float64's cost it at most {gap:.3e} more "
              f"than its optimum (margin {ASSIGN_MARGIN:.0e})")
        if differ and not gap <= ASSIGN_MARGIN:
            failures.append(f"{arm} assignments differ from float64's beyond a near-tie ({gap:.3e})")
    for key, ref in m_r.items():
        rel_k = abs(m_k[key] - ref) / max(abs(ref), 1e-30)
        rel_p = abs(m_p[key] - ref) / max(abs(ref), 1e-30)
        # the norm is over gradients that may hold a flip; the two logging errors
        # count arg-maxes over 1849 near-equal logits and are reported only
        tol = (DET_LOSS_TOL if key.startswith("loss") else DET_FLIP_TOL if key == "grad_norm"
               else None)
        print(f"[detector parity] {key:<18} float64 {ref:.9e}: kernel rel err {rel_k:.3e}, "
              f"plain {rel_p:.3e} (tol {tol})")
        if not np.isfinite(m_k[key]) or (tol is not None and rel_k > tol):
            failures.append(f"{key} rel err {rel_k:.3e} > {tol}")
    worst: dict[str, list] = {}
    for name, gr in grad_r.items():
        gk, gp = grad_k[name], grad_p[name]
        upd, lr, wd, p0 = upd_k[name]
        scale = gr.abs().max().clamp(min=GRAD_FLOOR)
        k_err = ((gk - gr).abs().max() / scale).item()
        p_err = ((gp - gr).abs().max() / scale).item()
        # AdamW's first step on the clipped gradient, with the decoupled decay
        a_err = max(0.0, (upd + lr * (gk / (gk.abs() + 1e-8) + wd * p0)).abs().max().item()
                    - 1.2e-7 * p0.abs().max().item()) / lr
        gname = next((g for g, key in DET_PARITY_GROUPS if name.startswith(key)), "other")
        rec = worst.setdefault(gname, [0.0, 0.0, 0.0, ""])
        if k_err > rec[0]:
            rec[3] = name
        for j, v in enumerate((k_err, p_err, a_err)):
            rec[j] = max(rec[j], v)
        if not k_err <= DET_FLIP_TOL:
            failures.append(f"{name} gradient err {k_err:.3e} > {DET_FLIP_TOL}")
        if not a_err <= UPDATE_TOL:
            failures.append(f"{name} update err {a_err:.3e} of lr > {UPDATE_TOL:.0e}")
    print(f"[detector parity] worst leaf by module group, against float64: the kernel path's "
          f"clipped gradient err (share of the leaf's max; tol {DET_FLIP_TOL}), the plain path's, and "
          f"the kernel path's update against AdamW's step (share of lr; tol {UPDATE_TOL:.0e})")
    for gname, (k_err, p_err, a_err, name) in worst.items():
        print(f"[detector parity]   {gname:<18} kernel {k_err:.3e}  plain {p_err:.3e}  "
              f"adam {a_err:.3e}  ({name})", flush=True)
    RESULTS["detector_parity"] = {
        "batch": batch, "metrics": {"float64": m_r, "kernel": m_k, "plain": m_p},
        "lsa_on_float64_costs": {"differ": differ_f64, "gap": gap_f64},
        "assignment_gap": {"kernel": gap_k, "plain": gap_p},
        "groups": {g: {"kernel": v[0], "plain": v[1], "adam": v[2], "leaf": v[3]}
                   for g, v in worst.items()}}
    if failures:
        fail("detector parity: " + "; ".join(failures[:10]))


# ---------------------------------------------------------------------------
# the other Swin presets: large (C 192, window 12), small and tiny (C 96,
# window 7), nano (C 64, window 7), at full width on random weights
# ---------------------------------------------------------------------------
PRESETS = ("swin_large_win7_384_22k", "swin_small", "swin_tiny", "swin_nano")
LARGE = "swin_large_win7_384_22k"
PRESET_PARITY_BATCH = 4


def preset_stages(name: str, hw) -> list:
    """A preset's stage maps at image size ``hw`` (H/4 ... H/32), each padded
    to window multiples, as STAGES lists them: (name, C, heads, real (h, w),
    padded (Hp, Wp), depth)."""
    bb = BACKBONES[name]
    win, h, w = bb["window"], hw[0] // 4, hw[1] // 4
    stages = []
    for i, (depth, heads) in enumerate(zip(bb["depths"], bb["num_heads"])):
        stages.append((f"stage{i + 1}", bb["embed_dim"] * 2 ** i, heads, (h, w),
                       (-(-h // win) * win, -(-w // win) * win), depth))
        h, w = (h + 1) // 2, (w + 1) // 2
    return stages


def preset_config(name: str):
    """The caption config on another preset: ``model.backbone`` and the grid
    net's input width, ``model.grid_feat_dim``, set to the preset's pos_dim."""
    config = default_caption_config()
    config.model.backbone = name
    config.model.grid_feat_dim = BACKBONES[name]["pos_dim"]
    return config


def phase_preset_kernels() -> None:
    """K1, K2, K10a and K10b at the b8 384x640 caption shapes of each preset;
    K4, K5 (and the frozen stage's K1, K2) at the b16 XE shapes of swin_small
    (window 7) and swin_large (window 12), and at the b4 832x1344 detector
    shapes of swin_tiny, where every stage trains: each in fp32 and bf16
    against its plain version (checks, not timed: phase_preset_yardsticks
    times the GEMM, core and backward launches at these shapes)."""
    for name in PRESETS:
        stages = preset_stages(name, HW)
        phase_kernels(8, counted=False, stages=stages, preset=name)
        phase_merge_kernels(paths=(("caption", 8, stages, HW),), counted=False, preset=name)
    for name in ("swin_small", LARGE):
        phase_train_kernels(TRAIN_BATCH, counted=False, stages=preset_stages(name, HW),
                            preset=name)
    phase_train_kernels(DET_BATCH, counted=False, stages=preset_stages("swin_tiny", DET_HW),
                        hw=DET_HW, n_frozen=0, run="detector", preset="swin_tiny")


def phase_preset_yardsticks() -> None:
    """The GEMM (its N and K tails), the attention core and, at the training
    runs, the attention backward (N = 49) at the presets' shapes, each against
    its plain version, timed beside F.linear, SDPA + mask and SDPA's backward:
    a b8 caption forward of each width family (nano C 64, tiny C 96, large C
    192), a b16 XE step of swin_small and a b4 832x1344 detector step of
    swin_tiny."""
    for name in ("swin_nano", "swin_tiny", LARGE):
        stages = preset_stages(name, HW)
        phase_yardsticks("caption", 8, stages, len(stages), preset=name)
    phase_yardsticks("train", TRAIN_BATCH, preset_stages("swin_small", HW), FROZEN_STAGES - 1,
                     preset="swin_small")
    phase_yardsticks("detector", DET_BATCH, preset_stages("swin_tiny", DET_HW), 0,
                     preset="swin_tiny")


def phase_preset_slice(name: str, card: str, batch: int = 8) -> None:
    """Caption inference on a preset at full width, random weights (seed 0),
    b8 bf16 384x640, beam 5, 20 steps, EOS off, through
    ``make_caption_generator``: the launches of one batch checked (K1 and K2
    = sum(depths)), then the median of 3 timed batches and one profiled."""
    config = preset_config(name)
    vocab = config.model.vocab_size
    model = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0)
    samples = synthetic_batch(batch)
    gen = make_caption_generator(model, beam_size=BEAM, max_len=STEPS,
                                 bos_idx=config.model.bos_idx, eos_idx=vocab)
    gen(samples, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = gen(samples, batch)
    torch.cuda.synchronize()
    stages = preset_stages(name, HW)
    blocks = sum(s[-1] for s in stages)
    counts = {**caption_launches(), **core_launches(), **f32_launches()}
    want = {**forward_launches(stages=stages), "K11": config.model.cap_generator.n_layers * STEPS,
            "gemm_bf16": 4 * blocks + len(stages), "win_attn": blocks, "win_attn_bwd": 0,
            "gemm_f32": 0, "win_attn_f32": 0, "win_attn_bwd_f32": 0}
    print(f"[preset {name}] launches in one b{batch} caption batch: {counts} (want {want})")
    if counts != want:
        fail(f"preset {name}: caption launch counts {counts} != {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = gen(samples, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = out.cpu()
    if tuple(out.shape) != (batch, STEPS) or out.min() < 0 or out.max() >= vocab:
        fail(f"preset {name}: bad tokens, shape {tuple(out.shape)}")
    prof = profile_run(lambda: gen(samples, batch), f"b{batch} bf16 caption batch {name} [{card}]",
                       f"profile_{name}.txt", 6)
    med = sorted(times)[1]
    print(f"[preset {name}] b{batch} bf16 beam {BEAM} x {STEPS} steps at {HW[0]}x{HW[1]}: "
          f"{med * 1e3:.1f} ms/batch (median of 3: {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
          f"peak {peak:.2f} GiB; profiled: device busy {prof['busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}  [{card}]", flush=True)
    RESULTS[f"slice {name}"] = {"batch": batch, "seconds": times, "peak_gib": peak,
                                "launches": counts, "profile": prof}


def phase_preset_parity(name: str, batch: int = 8) -> None:
    """The preset's captioner in fp32, kernel path against plain path on the
    same b8 batch: gri_feat (the backbone's last map through the grid net)
    and each deformable decoder layer on the same inputs within FEATURE_TOL,
    captions token for token (near-ties excepted).  reg_feat, run freely, is
    reported: the random-weight decoder multiplies the backbone's ~2e-6 by
    2-4.5 at each of its layers (see REG_FEAT_TOL), and the larger
    backbones' maps reach it with more (swin_large: 1.1e-3)."""
    config = preset_config(name)
    model = build_captioner(config, device=DEV, dtype=torch.float32, seed=0)
    samples = synthetic_batch(batch)

    def run():
        return beam_run(model, samples, batch, config.model.bos_idx, config.model.vocab_size,
                        return_margins=True)

    vis_k, res_k = run()
    with plain_arm():
        vis_p, res_p = run()
    errs = decoder_layer_errors(model, samples)
    print(f"[preset {name}] fp32 decoder state max rel err by layer, same inputs: "
          + " ".join(f"{e:.3e}" for e in errs))
    print(f"[preset {name}] fp32 reg_feat run freely: max rel err "
          f"{max_rel(vis_k['reg_feat'], vis_p['reg_feat']):.3e} (reported)")
    for what, feat, rel in (("gri_feat", vis_k["gri_feat"],
                             max_rel(vis_k["gri_feat"], vis_p["gri_feat"])),
                            ("decoder layers on the same inputs", vis_k["reg_feat"], max(errs))):
        print(f"[preset {name}] fp32 {what}: max rel err {rel:.3e} (tol {FEATURE_TOL:.0e})",
              flush=True)
        if not torch.isfinite(feat).all() or rel > FEATURE_TOL:
            fail(f"preset {name}: fp32 {what} max rel err {rel:.3e} > {FEATURE_TOL:.0e}")
    same_tokens(f"preset {name}", res_k.sequences[:, 0], res_p.sequences[:, 0],
                res_k.margins.cpu())


def phase_preset_train(name: str, card: str) -> None:
    """One XE step at full width on a preset, b16 bf16 over f32 masters,
    ``frozen_stages=2``, dropouts and drop-path on, through
    ``make_xe_train_step``: a warm-up step, one step whose launches are
    checked (K4 and K5 once a training block), one profiled step."""
    state, step, tbatch = training_setup(preset_config(name), torch.bfloat16, TRAIN_BATCH)
    losses = [float(step(state, tbatch)[1]["loss"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses.append(float(step(state, tbatch)[1]["loss"]))     # synchronises
    step_s = time.perf_counter() - t0
    counts = {**train_launches(), **f32_launches()}
    want = {**train_want(preset_stages(name, HW)), "gemm_f32": 0, "win_attn_f32": 0,
            "win_attn_bwd_f32": 0}
    print(f"[preset {name}] launches in one b{TRAIN_BATCH} XE step: {counts} (want {want})")
    if counts != want:
        fail(f"preset {name}: XE launch counts {counts} != {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_run(lambda: step(state, tbatch), f"b{TRAIN_BATCH} bf16 XE step {name} [{card}]",
                       f"profile_train_{name}.txt", 6)
    if not np.isfinite(losses).all():
        fail(f"preset {name}: XE losses {losses}")
    for pname, prm in state.model.named_parameters():
        if prm.dtype != torch.float32 or not torch.isfinite(prm).all():
            fail(f"preset {name}: parameter {pname} is {prm.dtype} or non-finite")
    print(f"[preset {name}] b{TRAIN_BATCH} bf16 XE step at {HW[0]}x{HW[1]}, frozen_stages="
          f"{FROZEN_STAGES}: losses {losses}, the counted step {step_s * 1e3:.1f} ms, peak "
          f"{peak:.2f} GiB; profiled: device busy {prof['busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}  [{card}]", flush=True)
    RESULTS[f"train {name}"] = {"batch": TRAIN_BATCH, "losses": losses, "step_s": step_s,
                                "peak_gib": peak, "launches": counts, "profile": prof}
    del state, step, tbatch


# ---------------------------------------------------------------------------
# data parallel: two ranks under DistributedDataParallel against one process
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_DEADLINE = 600.0     # seconds the ranks may take; past it they are killed
DP_TIMED_STEPS = 3
DP_EVAL_BATCH = 8


#: of a leaf's max gradient: below it (or below 1e-6, where a gradient that is
#: zero in exact arithmetic, as an attention key bias's, holds f32 noise) the
#: sign of Adam's first step is noise
DP_GRAD_FLOOR = 1e-5


def dp_held(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def dp_xe_setup(config, batch: int):
    """``training_setup`` in fp32, dropouts off, the norms perturbed as the
    detector's (``perturb_norms``: else the padded images' gradients grow
    316x at every LayerNorm, to 1e10 at full width)."""
    state, _, tbatch = training_setup(config, torch.float32, batch, dropouts=False)
    perturb_norms(state.model, 1)
    return state, tbatch


def dp_scst_probe(part: dict, m):
    """The XE probe on a SCST part's first image and first beam."""
    caps = torch.cat([torch.full((1, 1), m.bos_idx, device=DEV), part["sequences"][:1, 0]], 1)
    return xe_lib.xe_probe([{"samples": part["samples"], "captions": caps}], pad_idx=m.pad_idx)


def dp_scst_inputs(config):
    """SC_BATCH images' beams (EOS at varying steps) and rewards, from a seed."""
    m = config.model
    rng = np.random.default_rng(5000 + BATCH_SEED)
    seqs = rng.integers(4, m.vocab_size, (SC_BATCH, BEAM, STEPS))
    for i in range(SC_BATCH):
        seqs[i, i % BEAM, 6 + i:] = m.eos_idx
    rewards = (rng.random((SC_BATCH, BEAM)) * 2).astype(np.float32)
    return synthetic_batch(SC_BATCH, 3), torch.from_numpy(seqs).to(DEV), torch.from_numpy(rewards)


def dp_eval_model(config):
    return build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0)


def dp_caption_generator(model, config):
    m = config.model
    return make_caption_generator(model, beam_size=BEAM, max_len=STEPS, bos_idx=m.bos_idx,
                                  eos_idx=m.vocab_size)


def dp_update_error(model, ref: dict) -> tuple[float, float, str]:
    """(the worst |p - p_ref| in learning rates where the one-process gradient
    is above DP_GRAD_FLOOR of its leaf's max and 1e-6, the worst elsewhere,
    the leaf of the first) over the leaves the one process trained, beyond
    one f32 rounding of the parameter.  ``model``: a model, or a dict of its
    parameters by name."""
    worst, noise, where = 0.0, 0.0, ""
    for name, p in model.items() if isinstance(model, dict) else model.named_parameters():
        if name not in ref["params"]:
            continue
        want = ref["params"][name].to(p.device)
        # beyond one f32 rounding of the parameter: updates that agree within
        # UPDATE_TOL may still round to neighbouring floats
        err = ((p.detach() - want).abs() - torch.finfo(torch.float32).eps * want.abs()
               ).clamp(min=0) / ref["lr"][name]
        big = ref["big"][name].to(p.device)
        if bool(big.any()) and float(err[big].max()) > worst:
            worst, where = float(err[big].max()), name
        if bool((~big).any()):
            noise = max(noise, float(err[~big].max()))
    return worst, noise, where


def dp_ranks_equal(model) -> bool:
    """Whether every rank's trainable parameters equal rank 0's bit for bit."""
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters() if p.requires_grad])
    other = flat.clone()
    torch.distributed.broadcast(other, 0)
    same = torch.tensor([float(torch.equal(flat, other))], device=flat.device)
    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
    return bool(same.item())


def dp_collective_ms(fn) -> dict:
    """torch.profiler over one call of ``fn``: the device time of the
    collectives' kernels (NCCL) and of the copies gloo makes of CUDA tensors,
    the host time in the all-reduce calls, the device busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    nccl = copies = busy = host = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.key.startswith("Optimizer."):
                busy += dev
            if "nccl" in e.key.lower():
                nccl += dev
            elif "memcpy" in e.key.lower() and ("dtoh" in e.key.lower() or "htod" in e.key.lower()):
                copies += dev
        elif (e.device_type == torch.autograd.DeviceType.CPU
              and ("all_reduce" in e.key.lower() or "allreduce" in e.key.lower())):
            host = max(host, e.cpu_time_total)
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / 1e3 / (wall * 1e3),
            "nccl_kernel_ms": nccl / 1e3, "copy_ms": copies / 1e3, "allreduce_host_ms": host / 1e3}


def dp_parts(tree, **pad) -> list:
    """The global batch's rows in the ranks' groups (rank r: rows r, r + 2, ...)."""
    return [shard_batch(tree, r, DP_WORLD, **pad) for r in range(DP_WORLD)]


def dp_reference_xe(config) -> dict:
    """One process's fp32 XE step over the global batch in the ranks' row
    groups, accumulated (``dryrun.one_process_xe_step``): each group's
    kernels run at a rank's shapes (cuBLAS and cuDNN choose their kernels by
    the batch, so one forward of all 16 rows rounds differently, and MSDA
    floors and ReLU gates can flip), with the ranks' set of trained
    parameters (``exclude_untrained``)."""
    m = config.model
    state, batch = dp_xe_setup(config, TRAIN_BATCH)
    model, opt = state.model, state.optimizer
    parts = dp_parts(batch, int_fill=m.pad_idx, int_first=m.bos_idx)
    exclude_untrained(model, trained=dp_held(opt),
                      probe=xe_lib.xe_probe(parts[:1], pad_idx=m.pad_idx))
    loss = one_process_xe_step(state, parts, pad_idx=m.pad_idx, sched_cfg=SCHED)
    lr = {id(p): g["lr"] for g in opt.param_groups for p in g["params"]}
    out = {"loss": loss, "params": {}, "big": {}, "lr": {}}
    for name, p in model.named_parameters():
        if id(p) in lr and p.grad is not None:
            out["params"][name] = p.detach().cpu()
            floor = max(1e-6, DP_GRAD_FLOOR * float(p.grad.abs().max()))
            out["big"][name] = (p.grad.abs() > floor).cpu()
            out["lr"][name] = lr[id(p)]
    return out


def dp_reference_scst(config) -> dict:
    """One process's fp32 SCST update over the global batch in the ranks'
    row groups, accumulated (see ``dp_reference_xe``)."""
    m, o = config.model, config.optimizer
    state, _ = dp_xe_setup(config, SC_BATCH)
    model, opt = state.model, state.optimizer
    samples, seqs, rewards = dp_scst_inputs(config)
    parts = dp_parts({"samples": samples, "sequences": seqs, "rewards": rewards.to(DEV)})
    exclude_untrained(model, trained=dp_held(opt), probe=dp_scst_probe(parts[0], m))
    model.train()
    opt.param_groups[0]["lr"], opt.param_groups[1]["lr"] = o.sc_lr, o.sc_backbone_lr
    opt.zero_grad(set_to_none=True)
    denom = torch.tensor(float(SC_BATCH * BEAM), device=DEV)
    sums = {"loss": 0.0, "reward": 0.0, "reward_baseline": 0.0}
    for p in parts:
        logp = scst_lib.sequence_log_probs(model, p["samples"], p["sequences"],
                                           bos_idx=m.bos_idx, eos_idx=m.eos_idx)
        baseline = p["rewards"].mean(-1, keepdim=True)
        loss = (-logp.mean(-1) * (p["rewards"] - baseline)).sum() / denom
        loss.backward()
        sums["loss"] += float(loss)
        sums["reward"] += float(p["rewards"].sum() / denom)
        sums["reward_baseline"] += float(baseline.sum() * BEAM / denom)
    opt.step()
    return sums


def dp_reference_detector(images, targets, assigns) -> dict:
    """One process's fp32 detector step over the global batch in the ranks'
    row groups, accumulated, normalised by the whole batch's box count, then
    clipped and stepped as ``make_detector_train_step`` does."""
    config, state, criterion, _ = detector_setup(torch.float32, dropouts=False)
    model, opt = state.model, state.optimizer
    parts = dp_parts({"samples": images, "targets": targets})
    exclude_untrained(model, trained=dp_held(opt),
                      probe=det_solver.detector_probe(criterion, parts[:1]))
    model.train()
    optim_lib.apply_detector_lr(opt, 1.0, 1.0)
    opt.zero_grad(set_to_none=True)
    boxes = targets["valid"].sum().float()
    loss = 0.0
    for r, p in enumerate(parts):
        part = criterion.total_loss(criterion(model(p["samples"], training=True), p["targets"],
                                              assigns=assigns[:, r::DP_WORLD].contiguous(),
                                              num_boxes=boxes))
        part.backward()
        loss += float(part)
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = det_solver.clip_grad_norm(params, config.optimizer.clip_max_norm)
    opt.step()
    return {"loss": loss, "grad_norm": float(norm)}


def dp_references(work: str) -> dict:
    """One process on this card, the inputs the ranks will share and what
    they must reproduce: the rank-specialised evaluation's splits and
    scores; the fp32 XE step, the SCST update and the detector step, each
    over the global batch in the ranks' row groups (held) and in one forward
    (reported); the detector's sharded validation.  Written to
    ``work``/ref.pt; returns the scalars."""
    config = default_caption_config()
    m = config.model
    ref: dict = {}

    # -- the evaluation's splits: references made from one process's captions
    model = dp_eval_model(config)
    gen = dp_caption_generator(model, config)
    text_field = synthetic_text_field(m.vocab_size)
    rng = np.random.default_rng(6000 + BATCH_SEED)
    splits, scores = {}, {}
    for j, split in enumerate(("valid", "test")):
        samples = on_host(synthetic_batch(DP_EVAL_BATCH, 20 + j))
        ids = list(range(j * DP_EVAL_BATCH, (j + 1) * DP_EVAL_BATCH))
        caps = text_field.decode(gen(samples.to(DEV), DP_EVAL_BATCH).cpu().numpy())
        refs = [[" ".join(w if rng.random() > 1 / 3 else f"w{rng.integers(0, 1000)}"
                          for w in (c.split() or ["w0"])) for _ in range(5)] for c in caps]
        splits[split] = [{"samples": samples, "image_id": ids, "captions": refs}]
        scores[split] = evaluate_metrics(gen, splits[split], text_field, device=DEV,
                                         verbose=False)[0]
    ref["eval"] = {"splits": splits, "scores": scores}
    del model, gen
    free_card()

    # -- the fp32 XE step and the SCST update: one forward, then row groups
    state, batch = dp_xe_setup(config, TRAIN_BATCH)
    step = xe_lib.make_xe_train_step(pad_idx=m.pad_idx, sched_cfg=SCHED)
    single = {"xe_loss": float(step(state, batch)[1]["loss"])}
    del state, step, batch
    free_card()
    ref["xe"] = dp_reference_xe(config)
    free_card()
    state, _ = dp_xe_setup(config, SC_BATCH)
    samples, seqs, rewards = dp_scst_inputs(config)
    update = scst_lib.make_scst_update_step(bos_idx=m.bos_idx, eos_idx=m.eos_idx,
                                            model_lr=config.optimizer.sc_lr,
                                            backbone_lr=config.optimizer.sc_backbone_lr)
    single["scst_loss"] = float(update(state, samples, seqs, rewards.numpy(), SC_BATCH)[1]["loss"])
    del state, update
    free_card()
    ref["scst"] = dp_reference_scst(config)
    free_card()

    # -- the detector: sharded validation of the initial weights, one step in
    # one forward (its Hungarian assignments serve every arm), then row groups
    _, state, criterion, step = detector_setup(torch.float32, dropouts=False)
    model = state.model
    first = CocoEvaluator({})
    det_solver.Valider(lambda: model, dp_detector_shards(), lambda: first,
                       device=DEV).run_epoch(0)
    gt = {}
    for i, p in first.preds.items():     # each image's three best detections as its boxes
        top = np.argsort(-p["scores"])[:3]
        gt[i] = {"boxes": p["boxes"][top], "labels": p["labels"][top]}
    whole = CocoEvaluator(gt)
    whole.preds = dict(first.preds)
    ref["det_eval"] = {"gt": gt, "summary": whole.summarize()}
    images = detector_images(DET_BATCH).to(DEV)
    targets = {k: torch.from_numpy(v).to(DEV)
               for k, v in detector_targets(DET_BATCH, criterion.num_classes).items()}
    targets["labels"] = targets["labels"].long()
    with torch.no_grad():
        assigns = criterion.match_levels(model(images, training=True), targets)
    _, metrics = step(state, images, targets, assigns=assigns)
    single.update(det_loss=float(metrics["loss"]), det_grad_norm=float(metrics["grad_norm"]))
    del state, model, criterion, step, metrics
    free_card()
    ref["det"] = {**dp_reference_detector(images, targets, assigns), "assigns": assigns.cpu()}
    free_card()
    torch.save(ref, os.path.join(work, "ref.pt"))
    return {"xe_loss": ref["xe"]["loss"], "scst": ref["scst"],
            "det_loss": ref["det"]["loss"], "det_grad_norm": ref["det"]["grad_norm"],
            "det_eval": ref["det_eval"]["summary"], "eval": scores, "one_forward": single}


def dp_detector_shards(rank_: int | None = None) -> list:
    """The sharded validation's batches: four images in the 832x1344 bucket,
    rank r's shard rows r, r + 2 (one b2 batch each); None: both shards, in
    rank order, for one process."""
    images = detector_images(DET_BATCH, offset=7)
    out = []
    for r in range(DP_WORLD) if rank_ is None else (rank_,):
        out.append({"samples": shard_batch(images, r, DP_WORLD),
                    "orig_sizes": np.tile([[DET_HW[0], DET_HW[1]]], (DET_BATCH // DP_WORLD, 1)),
                    "image_id": list(range(DET_BATCH))[r::DP_WORLD]})
    return out


def dp_rank(work: str, profile: bool) -> dict:
    """One rank of phase_data_parallel (started by ``run_ranks``): each run of
    the main paths on this rank's share of the global batch, the model under
    DistributedDataParallel, held against the one-process references in
    ``work``/ref.pt by the parent; without TF32, as the parent (``run_ranks``
    passes its settings on)."""
    r, w = dist_lib.rank(), dist_lib.world_size()
    ref = torch.load(os.path.join(work, "ref.pt"), weights_only=False)
    config = default_caption_config()
    m = config.model
    out: dict = {"rank": r, "card": torch.cuda.current_device()}

    # -- rank-specialised evaluation: valid on rank 0, test on rank 1
    model = dp_eval_model(config)
    out["eval"] = evaluate_splits(dp_caption_generator(model, config), ref["eval"]["splits"],
                                  synthetic_text_field(m.vocab_size), device=DEV)
    del model
    free_card()

    # -- fp32 XE step, dropouts off, 8 rows a rank
    state, batch = dp_xe_setup(config, TRAIN_BATCH)
    step = xe_lib.make_xe_train_step(pad_idx=m.pad_idx, sched_cfg=SCHED)
    model = state.model
    mine = shard_batch(batch, int_fill=m.pad_idx, int_first=m.bos_idx)
    state.model = wrap_data_parallel(model, DEV, trained=dp_held(state.optimizer),
                                     probe=xe_lib.xe_probe([mine], pad_idx=m.pad_idx))
    _, metrics = step(state, mine)
    out["ddp"] = type(state.model).__name__
    out["xe_loss"] = float(global_sum(metrics["loss"]))
    out["xe_update"] = dp_update_error(model, ref["xe"])
    out["xe_ranks_equal"] = dp_ranks_equal(model)
    out["allreduce_bytes"] = 4 * sum(p.numel() for p in model.parameters() if p.requires_grad)
    del state, step, batch, model, mine, metrics
    free_card()

    # -- bf16 XE steps, dropouts on (each rank its own masks), timed
    state, step, batch = training_setup(config, torch.bfloat16, TRAIN_BATCH, seed=0)
    model = state.model
    state.generator = torch.Generator(device=DEV).manual_seed(r)
    mine = shard_batch(batch, int_fill=m.pad_idx, int_first=m.bos_idx)
    state.model = wrap_data_parallel(model, DEV, trained=dp_held(state.optimizer),
                                     probe=xe_lib.xe_probe([mine], pad_idx=m.pad_idx))
    step(state, mine)                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, metrics = step(state, mine)
    torch.cuda.synchronize()
    out["launches"], out["want"] = train_launches(), train_want()
    losses, times = [float(global_sum(metrics["loss"]))], []
    for _ in range(DP_TIMED_STEPS):
        dist_lib.barrier("timed_step")
        t0 = time.perf_counter()
        _, metrics = step(state, mine)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(global_sum(metrics["loss"])))
    out["bf16"] = {"ms": times, "losses": losses,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile:
        dist_lib.barrier("profiled_step")
        out["bf16"]["profile"] = dp_collective_ms(lambda: step(state, mine))
    del state, step, batch, model, mine, metrics
    free_card()

    # -- SCST update, fp32, dropouts off, 4 images a rank
    state, _ = dp_xe_setup(config, SC_BATCH)
    model = state.model
    samples, seqs, rewards = dp_scst_inputs(config)
    mine = shard_batch({"samples": samples, "sequences": seqs, "rewards": rewards})
    state.model = wrap_data_parallel(model, DEV, trained=dp_held(state.optimizer),
                                     probe=dp_scst_probe(mine, m))
    update = scst_lib.make_scst_update_step(bos_idx=m.bos_idx, eos_idx=m.eos_idx,
                                            model_lr=config.optimizer.sc_lr,
                                            backbone_lr=config.optimizer.sc_backbone_lr)
    _, metrics = update(state, mine["samples"], mine["sequences"], mine["rewards"].numpy(),
                        SC_BATCH // w)
    out["scst"] = {k: float(global_sum(v)) for k, v in metrics.items()}
    del state, model, update, metrics, mine
    free_card()

    # -- the detector: this rank's validation shard, merged; then an fp32 step
    _, state, criterion, step = detector_setup(torch.float32, dropouts=False)
    model = state.model
    out["det_eval"] = det_solver.Valider(
        lambda: model, dp_detector_shards(r), lambda: CocoEvaluator(ref["det_eval"]["gt"]),
        device=DEV).run_epoch(0)
    images = detector_images(DET_BATCH)
    targets = {k: torch.from_numpy(v) for k, v in
               detector_targets(DET_BATCH, criterion.num_classes).items()}
    targets["labels"] = targets["labels"].long()
    mine = to_device(shard_batch({"samples": images, "targets": targets}), DEV)
    state.model = wrap_data_parallel(model, DEV, trained=dp_held(state.optimizer),
                                     probe=det_solver.detector_probe(criterion, [mine]))
    _, metrics = step(state, mine["samples"], mine["targets"],
                      assigns=ref["det"]["assigns"][:, r::w].contiguous().to(DEV))
    out["det_loss"] = float(global_sum(metrics["loss"]))
    out["det_grad_norm"] = float(metrics["grad_norm"])
    out["det_ranks_equal"] = dp_ranks_equal(model)
    return out


def dp_world_one_steps(profile: bool) -> dict:
    """One process, no DDP: the bf16 XE step at a rank's rows (b8, rank 0's
    share), timed as the ranks time theirs."""
    config = default_caption_config()
    m = config.model
    state, step, batch = training_setup(config, torch.bfloat16, TRAIN_BATCH)
    mine = shard_batch(batch, 0, DP_WORLD, int_fill=m.pad_idx, int_first=m.bos_idx)
    step(state, mine)                                     # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(DP_TIMED_STEPS):
        t0 = time.perf_counter()
        step(state, mine)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"ms": times}
    if profile:
        out["profile"] = dp_collective_ms(lambda: step(state, mine))
    del state, step, batch, mine
    free_card()
    return out


def dp_nccl_world_one() -> dict:
    """NCCL started on this card through ``maybe_initialize`` from the
    variables torchrun sets for one rank: an all-reduce of the XE step's
    gradient size (the bytes DDP moves a step), device time by CUDA events."""
    import torch.distributed as dist

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(dist_lib.free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        r, w = dist_lib.maybe_initialize(DEV)
        backend = dist.get_backend()
        elements = RESULTS["data_parallel"]["allreduce_bytes"] // 4
        buf = torch.ones(elements, device=DEV)
        dist.all_reduce(buf)                              # warm-up (communicator)
        ms = cuda_ms(lambda: dist.all_reduce(buf), reps=5)
        ok = bool((buf == 1).all())
        dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"rank": r, "world": w, "backend": backend, "allreduce_ms": ms,
            "elements": elements, "sum_ok": ok}


def phase_data_parallel(card: str, profile: bool) -> None:
    """Two ranks under DistributedDataParallel at full width (Swin-B, the
    default caption and detection configs, random weights from seed 0,
    in-memory loaders), against one process on the same inputs: on two cards
    over NCCL when there are two, else both on this card over gloo (NCCL
    refuses a card twice).  The kernel library is built before the ranks
    start.  Checked: the rank-specialised evaluation (valid on rank 0, test
    on rank 1, both ranks holding both splits' scores, each one process's);
    an fp32 XE step at b16 global (loss LOSS_TOL, every updated leaf within
    UPDATE_TOL of its learning rate where the one-process gradient is above
    DP_GRAD_FLOOR of the leaf's max and 1e-6, and within two elsewhere; the
    ranks' parameters bit-equal); three timed bf16 XE steps (kernel launches as one
    process's step); an SCST update at b8 global (loss LOSS_TOL); the sharded
    detector validation (merged mAP exactly one process's); an fp32 detector
    step at b4 global with one process's Hungarian assignments (loss and
    clipped norm LOSS_TOL).  The one-process steps that updates and norms are
    held to run the global batch in the ranks' row groups, accumulated, with
    the ranks' set of trained parameters (``dp_reference_xe``); the losses
    are also held to one forward of the whole batch.  Then NCCL at world 1
    through ``maybe_initialize``, and ``dryrun_multichip(2, "cuda")``."""
    import shutil
    import tempfile

    two_cards = torch.cuda.device_count() >= DP_WORLD
    backend = "nccl" if two_cards else "gloo"
    print(f"[dp] {DP_WORLD} ranks " + ("on two cards over NCCL" if two_cards else
          "on this one card over gloo, passed explicitly (NCCL refuses a card twice): "
          "their times measure correctness, not scaling"), flush=True)
    free_card()
    world1 = dp_world_one_steps(profile)
    print(f"[dp] one process, no DDP: b{TRAIN_BATCH // DP_WORLD} bf16 XE step "
          f"{sorted(world1['ms'])[1]:.1f} ms (median of {len(world1['ms'])}: "
          f"{', '.join(f'{t:.1f}' for t in world1['ms'])})"
          + (f"; profiled: {json.dumps(world1['profile'])}" if "profile" in world1 else "")
          + f"  [{card}]", flush=True)
    work = tempfile.mkdtemp(prefix="grit_dp_")
    try:
        t0 = time.perf_counter()
        want = dp_references(work)
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            outs = dist_lib.run_ranks("chip_smoke:dp_rank", DP_WORLD, args=(work, profile),
                                      device=DEV, backend=backend,
                                      local_ranks=None if two_cards else [0] * DP_WORLD,
                                      deadline=DP_DEADLINE, threads=2)
        except RuntimeError as exc:
            fail(f"data parallel: {str(exc)[-6000:]}")
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)   # noqa: E731
    one = want["one_forward"]
    print(f"[dp] one process, the global batch in one forward: XE loss {one['xe_loss']:.9f}, "
          f"SCST loss {one['scst_loss']:.9f}, detector loss {one['det_loss']:.7f}, grad norm "
          f"{one['det_grad_norm']:.6e}; in the ranks' row groups (held below): "
          f"{want['xe_loss']:.9f}, {want['scst']['loss']:.9f}, {want['det_loss']:.7f}, "
          f"{want['det_grad_norm']:.6e}", flush=True)
    for o in outs:
        r = o["rank"]
        worst, noise, where = o["xe_update"]
        print(f"[dp] rank {r} (card {o['card']}, {o['ddp']}): fp32 XE loss {o['xe_loss']:.9f} "
              f"(one process {want['xe_loss']:.9f}, {rel(o['xe_loss'], want['xe_loss']):.2e}), "
              f"update {worst:.2e} lr ({where}), {noise:.2e} lr where the gradient is noise, "
              f"ranks bit-equal {o['xe_ranks_equal']}; SCST loss {o['scst']['loss']:.9f} "
              f"(one process {want['scst']['loss']:.9f}); detector loss {o['det_loss']:.7f} "
              f"({want['det_loss']:.7f}), grad norm {o['det_grad_norm']:.6e} "
              f"({want['det_grad_norm']:.6e})", flush=True)
        if o["ddp"] != "DistributedDataParallel":
            fail(f"data parallel: rank {r} trained a {o['ddp']}, not a DDP wrapper")
        for what, got, refs in (("XE", o["xe_loss"], (want["xe_loss"], one["xe_loss"])),
                                 ("SCST", o["scst"]["loss"], (want["scst"]["loss"],
                                                              one["scst_loss"])),
                                 ("detector", o["det_loss"], (want["det_loss"],
                                                              one["det_loss"]))):
            if any(rel(got, x) > LOSS_TOL for x in refs):
                fail(f"data parallel: rank {r}'s {what} loss {got} != one process's {refs}")
        if worst > UPDATE_TOL or noise > 2:
            fail(f"data parallel: rank {r}'s XE update {worst:.3e} / {noise:.3e} learning "
                 f"rates from one process's ({where})")
        if not (o["xe_ranks_equal"] and o["det_ranks_equal"]):
            fail("data parallel: the ranks' parameters differ after a step")
        for k in ("loss", "reward", "reward_baseline"):
            if rel(o["scst"][k], want["scst"][k]) > LOSS_TOL:
                fail(f"data parallel: rank {r}'s SCST {k} {o['scst'][k]} != {want['scst'][k]}")
        if (rel(o["det_loss"], want["det_loss"]) > LOSS_TOL
                or rel(o["det_grad_norm"], want["det_grad_norm"]) > LOSS_TOL):
            fail(f"data parallel: rank {r}'s detector step {o['det_loss']}, "
                 f"{o['det_grad_norm']} != {want['det_loss']}, {want['det_grad_norm']}")
        if o["eval"] != want["eval"]:
            fail(f"data parallel: rank {r}'s evaluation scores {o['eval']} != one process's "
                 f"{want['eval']}")
        if o["det_eval"] != want["det_eval"] or not want["det_eval"]["mAP"] > 0:
            fail(f"data parallel: rank {r}'s merged detector validation {o['det_eval']} != "
                 f"one process's {want['det_eval']}")
        if o["launches"] != o["want"]:
            fail(f"data parallel: rank {r}'s bf16 step launched {o['launches']}, want "
                 f"{o['want']}")
        b = o["bf16"]
        print(f"[dp] rank {r}: b{TRAIN_BATCH // DP_WORLD} bf16 XE step {sorted(b['ms'])[1]:.1f} "
              f"ms (median of {len(b['ms'])}: {', '.join(f'{t:.1f}' for t in b['ms'])}), "
              f"losses {', '.join(f'{x:.4f}' for x in b['losses'])}, peak "
              f"{b['peak_gib']:.2f} GiB, launches as one process's step"
              + (f"; profiled: {json.dumps(b['profile'])}" if "profile" in b else "")
              + f"  [{card}]", flush=True)
    print(f"[dp] the evaluation: valid on rank 0, test on rank 1, both ranks hold "
          f"{json.dumps({k: v['CIDEr'] for k, v in want['eval'].items()})} (CIDEr, one "
          f"process's); merged detector mAP {want['det_eval']['mAP']:.6f} on both ranks",
          flush=True)
    RESULTS["data_parallel"] = {
        "backend": backend, "two_cards": two_cards, "references_s": ref_s, "ranks_s": ranks_s,
        "world_one_steps": world1,
        "allreduce_bytes": outs[0]["allreduce_bytes"], "one_process": want,
        "ranks": [{k: v for k, v in o.items() if k not in ("eval", "want")} for o in outs]}
    nccl = dp_nccl_world_one()
    print(f"[dp] maybe_initialize at world 1 from torchrun's variables: {nccl['backend']}, "
          f"rank {nccl['rank']} of {nccl['world']}; all-reduce of {nccl['elements']} "
          f"f32 ({4 * nccl['elements'] / 2 ** 20:.0f} MiB) {nccl['allreduce_ms']:.3f} ms "
          f"device  [{card}]", flush=True)
    if nccl["backend"] != "nccl" or not nccl["sum_ok"]:
        fail(f"data parallel: world-1 NCCL {nccl}")
    RESULTS["data_parallel"]["nccl_world_one"] = nccl
    free_card()
    RESULTS["data_parallel"]["dryrun"] = dryrun_multichip(DP_WORLD, device=DEV)


# ---------------------------------------------------------------------------
# tensor parallel: two ranks over grit_tpu's model axis against one process
# ---------------------------------------------------------------------------

TP_WORLD = 2
TP_DEADLINE = 600.0
TP_TIMED = 3            # timed caption batches and XE steps, at tp1 and at tp2
TP_BATCH = 8            # the caption batch
#: the tp2 bf16 features' error against the fp32 one-process features, as a
#: multiple of one process's own bf16 error, past which an f32-store GEMM
#: epilogue (the partials leave the GEMM in bf16 today) is worth queueing
TP_BF16_RATIO = 1.5
#: bf16 XE updates: Adam's first step is the gradient's sign times lr, and
#: K6's atomic sums of the value gradient reach bf16's rounding, so one
#: process's step run twice flips ~8e4 of its 1.3e8 held elements (2 lr
#: each).  The ranks' step may flip at most this many times as many against
#: one process's; a split that loses a rank's share of a leaf's gradient
#: flips a large part of that leaf
TP_FLIP_RATIO = 2.0


@contextlib.contextmanager
def tp_arm(tp: int = TP_WORLD):
    """One process computing what ``tp`` tensor-parallel ranks compute: each
    FFN's and each Swin MLP's products in the ranks' slices of d_ff (each
    slice's weights contiguous, as a rank holds them), the partials summed in
    f32 in rank order, then each module's own finish.  The reference that the
    ranks' XE updates are held to, as phase_data_parallel's one process runs
    the ranks' row groups: cuBLAS and the GEMM kernels choose by shape, so a
    product over all of d_ff rounds differently from a rank's half, a ReLU
    gate at zero flips and Adam's first step moves that leaf's elements by
    two learning rates.  The slices read their input through one shared view,
    whose gradient is the sum of theirs before the residual's joins it, as
    ``copy_to_tp``'s all-reduce gives it to a rank (in bf16 the order of
    those sums rounds, and flips small gradients too).  Comparison only."""
    import torch.nn.functional as F

    from grit_tpu_torch.models.attention import FeedForward

    def slices(w, dim):
        return [c.contiguous() for c in w.chunk(tp, dim)]

    def ff_forward(self, x):
        dt, shared = x.dtype, x.view_as(x)
        parts = [F.linear(self.drop(F.relu(F.linear(shared, w1, b1))), w2).float()
                 for w1, b1, w2 in zip(slices(self.fc1.weight.to(dt), 0),
                                       slices(self.fc1.bias.to(dt), 0),
                                       slices(self.fc2.weight.to(dt), 1))]
        return self.finish(x, sum(parts[1:], parts[0]))

    def block_mlp(self, rows, residual):
        dt, m = rows.dtype, self.mlp
        shared = [t.view_as(t) for t in (rows, self.norm2.weight, self.norm2.bias)]
        parts = [wa.mlp(*shared, w1, b1, w2, None, eps=1e-5, residual=False).float()
                 for w1, b1, w2 in zip(slices(m.fc1.weight.to(dt), 0),
                                       slices(m.fc1.bias.to(dt), 0),
                                       slices(m.fc2.weight.to(dt), 1))]
        return self.mlp_finish(rows, sum(parts[1:], parts[0]), residual)

    saved = FeedForward.forward, SwinBlock._mlp
    FeedForward.forward, SwinBlock._mlp = ff_forward, block_mlp
    try:
        yield
    finally:
        FeedForward.forward, SwinBlock._mlp = saved


def tp_caption_model(config, dtype, group):
    model = build_captioner(config, device=DEV, dtype=dtype, seed=0)
    if group is not None:
        shard_model(model, tp_plan(model, tp_size(group)), group)
    return model


def reset_collectives() -> None:
    for k in tp_ops.COLLECTIVES:
        tp_ops.COLLECTIVES[k] = 0


def tp_caption_runs(config, group) -> dict:
    """The b8 caption batch at 384x640 (beam 5, 20 steps, EOS off) of the
    default model, split over ``group`` (None: one process): in fp32 its
    features, first-beam tokens and decision margins; in bf16 its features,
    then a warm-up batch, one counted batch (kernel launches, collectives),
    TP_TIMED timed batches and one profiled batch (device busy, idle share)."""
    m = config.model
    samples = synthetic_batch(TP_BATCH)
    model = tp_caption_model(config, torch.float32, group)
    vis, res = beam_run(model, samples, TP_BATCH, m.bos_idx, m.vocab_size, return_margins=True)
    out = {"fp32": {"seq": res.sequences[:, 0].cpu(), "margins": res.margins.cpu(),
                    "gri": vis["gri_feat"].cpu(), "reg": vis["reg_feat"].cpu()}}
    del model, vis, res
    free_card()
    model = tp_caption_model(config, torch.bfloat16, group)
    with torch.inference_mode():
        vis = model.compute_vis(samples)
    out["bf16"] = {"gri": vis["gri_feat"].float().cpu(), "reg": vis["reg_feat"].float().cpu()}
    gen = make_caption_generator(model, beam_size=BEAM, max_len=STEPS, bos_idx=m.bos_idx,
                                 eos_idx=m.vocab_size)
    gen(samples, TP_BATCH)                                  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    reset_collectives()
    seq = gen(samples, TP_BATCH)
    torch.cuda.synchronize()
    out["launches"] = {**caption_launches(),
                       "K11 partial": tail_ops.LAUNCHES["decode_tail_partial"],
                       "K11 finish": tail_ops.LAUNCHES["decode_tail_finish"]}
    out["collectives"] = dict(tp_ops.COLLECTIVES)
    out["bf16"]["seq"] = seq.cpu()
    times = []
    for _ in range(TP_TIMED):
        dist_lib.barrier("timed_batch")
        t0 = time.perf_counter()
        gen(samples, TP_BATCH)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = times
    dist_lib.barrier("profiled_batch")
    out["profile"] = dp_collective_ms(lambda: gen(samples, TP_BATCH))
    return out


def tp_xe_runs(config, dtype, group, dp_group=None, ref: dict | None = None,
               timed: int = 0) -> dict:
    """One b16 XE step of the default model in ``dtype`` (dropouts off, the
    norms perturbed as ``dp_xe_setup``'s, every rank all 16 rows), split over
    ``group`` (None: one process, under ``tp_arm`` when the caller asks for
    the ranks' slices), then ``timed`` timed steps -> its loss, the
    collectives of the checked step and the step times; with ``ref`` (one
    process's), the update error against it; without, what a rank is held to
    (the updated parameters, where the gradient is above DP_GRAD_FLOOR, the
    learning rates)."""
    m = config.model
    state, step, batch = training_setup(config, dtype, TRAIN_BATCH, dropouts=False,
                                        tp_group=group)
    perturb_norms(state.model, 1)
    model = state.model
    trained = dp_held(state.optimizer)
    probe = xe_lib.xe_probe([batch], pad_idx=m.pad_idx)
    if group is None:
        exclude_untrained(model, trained=trained, probe=probe)
    else:
        state.model = wrap_data_parallel(model, DEV, trained=trained, probe=probe, group=dp_group)
    reset_collectives()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    out = {"loss": float(global_sum(metrics["loss"])), "collectives": dict(tp_ops.COLLECTIVES)}
    if ref is None:
        lr = {id(p): g["lr"] for g in state.optimizer.param_groups for p in g["params"]}
        out.update(params={}, big={}, lr={})
        for name, p in model.named_parameters():
            if id(p) in lr and p.grad is not None:
                out["params"][name] = p.detach().cpu().clone()
                floor = max(1e-6, DP_GRAD_FLOOR * float(p.grad.abs().max()))
                out["big"][name] = (p.grad.abs() > floor).cpu()
                out["lr"][name] = lr[id(p)]
    else:
        whole = gather_tp_state(model)
        out["update"] = dp_update_error({k: whole[k] for k in ref["params"]}, ref)
        out["flips"] = update_flips({k: whole[k] for k in ref["params"]}, ref)
        del whole
        if group is not None:
            out["replicas_equal"] = tp_replicas_equal(model)
    times = []
    for _ in range(timed):
        dist_lib.barrier("timed_step")
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = times
    del state, step, batch, model
    free_card()
    return out


def update_flips(params: dict, ref: dict) -> tuple[int, int]:
    """(elements whose update differs from ``ref``'s by more than UPDATE_TOL
    lr where its gradient is above the floor, such elements in all): Adam's
    first step is the sign of the gradient times lr, so an element either
    agrees or has flipped (2 lr)."""
    far = held = 0
    for name, want in ref["params"].items():
        p = params[name].detach()
        want = want.to(p.device)
        err = ((p - want).abs() - torch.finfo(torch.float32).eps * want.abs()) / ref["lr"][name]
        big = ref["big"][name].to(p.device)
        far += int((err[big] > UPDATE_TOL).sum())
        held += int(big.sum())
    return far, held


def tp_replicas_equal(model) -> bool:
    """Whether every rank's trainable parameters that no tensor group splits
    equal rank 0's bit for bit."""
    split = split_params(model)
    flat = torch.cat([p.detach().reshape(-1) for n, p in model.named_parameters()
                      if p.requires_grad and n not in split])
    other = flat.clone()
    torch.distributed.broadcast(other, 0)
    same = torch.tensor([float(torch.equal(flat, other))], device=flat.device)
    torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
    return bool(same.item())


def tp_rank(work: str) -> dict:
    """One rank of phase_tensor_parallel (started by ``run_ranks``): the
    caption runs and the XE step with the model split over the two ranks
    (dp1 x tp2), the step held here against one process's in
    ``work``/ref.pt."""
    ref = torch.load(os.path.join(work, "ref.pt"), weights_only=False)
    config = default_caption_config()
    dp_group, tp_group = make_groups(1, TP_WORLD)
    out = {"rank": dist_lib.rank(), "card": torch.cuda.current_device(),
           "caption": tp_caption_runs(config, tp_group)}
    free_card()
    out["xe"] = {dn: tp_xe_runs(config, dtype, tp_group, dp_group, ref=ref[dn],
                                timed=TP_TIMED if dtype == torch.bfloat16 else 0)
                 for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    return out


def phase_tensor_parallel(card: str) -> None:
    """The tensor-parallel layout (grit_tpu's model axis, ``parallel.mesh``)
    at full width: Swin-B's 24 MLPs, the grid net's and the decoder's 3 FFNs
    each split over two ranks (the vocab head, 10201 wide, stays whole), on
    two cards over NCCL when there are two, else both ranks on this card
    over gloo; the kernel library is built before the ranks start.  Held
    against one process on the same inputs: the b8 caption batch's fp32
    tokens token for token (near-ties excepted, as phase_parity), its bf16
    grid features within TOL (3e-2) of one process's bf16 ones and the bf16
    error against fp32 printed beside one process's own; K2 24 and the split
    K11 60 + 60 launches (the whole K11 none) in a caption batch on each
    rank; one b16 XE step in fp32 and in bf16: its loss within LOSS_TOL of
    one process's and of one process's that computes the ranks' slices
    (``tp_arm``), its fp32 updates within UPDATE_TOL lr of the latter's (as
    phase_data_parallel holds them), its bf16 updates flipping at most
    TP_FLIP_RATIO times as many elements as that one process's step run
    twice flips against itself, the replicated parameters bit-equal on both
    ranks (``tie_replicated_grads``).  Printed: ms a batch and a step at tp1
    and tp2, device busy and idle share, the all-reduces' count and bytes a
    batch and a step.  Then ``dryrun_multichip(4, "cuda")``: dp4 and dp2tp2
    of the tiny captioner on four ranks."""
    import shutil
    import tempfile

    two_cards = torch.cuda.device_count() >= TP_WORLD
    backend = "nccl" if two_cards else "gloo"
    print(f"[tp] {TP_WORLD} ranks " + ("on two cards over NCCL" if two_cards else
          "on this one card over gloo: their times measure correctness, not scaling"),
          flush=True)
    config = default_caption_config()
    free_card()
    work = tempfile.mkdtemp(prefix="grit_tp_")
    try:
        t0 = time.perf_counter()
        one = {"caption": tp_caption_runs(config, None)}
        free_card()
        # one process as it is (held: the loss; tp1's times) and computing the
        # ranks' slices (held: the loss and the updates)
        saved, one["xe"], one["xe_split"] = {}, {}, {}
        for dn, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            run = tp_xe_runs(config, dtype, None, timed=TP_TIMED if dtype == torch.bfloat16 else 0)
            one["xe"][dn] = {k: run[k] for k in ("loss", "collectives", "ms")}
            del run
            with tp_arm():
                run = tp_xe_runs(config, dtype, None)
                saved[dn] = {k: run[k] for k in ("params", "big", "lr")}
                # the same step once more: one process against itself
                again = tp_xe_runs(config, dtype, None, ref=saved[dn])
            one["xe_split"][dn] = {"loss": run["loss"], "again_loss": again["loss"],
                                   "again_update": again["update"], "again_flips": again["flips"]}
            print(f"[tp] one process computing the ranks' slices, {dn} XE step run twice: loss "
                  f"{run['loss']:.9f} / {again['loss']:.9f}, update {again['update'][0]:.2e} lr "
                  f"({again['update'][2]}), {again['flips'][0]} of {again['flips'][1]} held "
                  f"elements beyond {UPDATE_TOL:.0e} lr", flush=True)
            del run, again
        torch.save(saved, os.path.join(work, "ref.pt"))
        del saved
        free_card()
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            outs = dist_lib.run_ranks("chip_smoke:tp_rank", TP_WORLD, args=(work,), device=DEV,
                                      backend=backend,
                                      local_ranks=None if two_cards else [0] * TP_WORLD,
                                      deadline=TP_DEADLINE, threads=2)
        except RuntimeError as exc:
            fail(f"tensor parallel: {str(exc)[-6000:]}")
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)   # noqa: E731
    c1 = one["caption"]
    want = {**forward_launches(), "K11": 0,
            "K11 partial": config.model.cap_generator.n_layers * STEPS,
            "K11 finish": config.model.cap_generator.n_layers * STEPS}
    for o in outs:
        r, c = o["rank"], o["caption"]
        same_tokens(f"tp rank {r}", c["fp32"]["seq"], c1["fp32"]["seq"], c["fp32"]["margins"])
        if not torch.equal(c["fp32"]["seq"], outs[0]["caption"]["fp32"]["seq"]):
            fail("tensor parallel: the two ranks' fp32 tokens differ")
        if not torch.equal(c["bf16"]["seq"], outs[0]["caption"]["bf16"]["seq"]):
            fail("tensor parallel: the two ranks' bf16 beams differ")
        errs = {}
        for key in ("gri", "reg"):
            a, b1, f = c["bf16"][key], c1["bf16"][key], c1["fp32"][key]
            errs[key] = {"vs_one_process_bf16": max_rel(a, b1), "tp2_vs_fp32": rms_rel(a, f),
                         "one_process_vs_fp32": rms_rel(b1, f),
                         "fp32_tp2_vs_fp32": max_rel(c["fp32"][key], f)}
        o["errors"] = errs
        print(f"[tp] rank {r} (card {o['card']}): fp32 features against one process's, max "
              f"rel: gri_feat {errs['gri']['fp32_tp2_vs_fp32']:.3e}, reg_feat "
              f"{errs['reg']['fp32_tp2_vs_fp32']:.3e}; bf16 against one process's bf16, max rel: "
              f"gri_feat {errs['gri']['vs_one_process_bf16']:.3e} (tol {TOL[torch.bfloat16]:.0e}), "
              f"reg_feat {errs['reg']['vs_one_process_bf16']:.3e}; bf16 against fp32, relative "
              f"RMS: tp2 gri_feat {errs['gri']['tp2_vs_fp32']:.3e} (one process "
              f"{errs['gri']['one_process_vs_fp32']:.3e}), reg_feat "
              f"{errs['reg']['tp2_vs_fp32']:.3e} ({errs['reg']['one_process_vs_fp32']:.3e})",
              flush=True)
        if not all(torch.isfinite(c["bf16"][k]).all() for k in ("gri", "reg")):
            fail(f"tensor parallel: rank {r}'s bf16 features are not finite")
        if errs["gri"]["vs_one_process_bf16"] > TOL[torch.bfloat16]:
            fail(f"tensor parallel: rank {r}'s bf16 gri_feat "
                 f"{errs['gri']['vs_one_process_bf16']:.3e} from one process's")
        if errs["gri"]["fp32_tp2_vs_fp32"] > FEATURE_TOL:
            fail(f"tensor parallel: rank {r}'s fp32 gri_feat {errs['gri']['fp32_tp2_vs_fp32']:.3e} "
                 f"from one process's")
        if {k: c["launches"][k] for k in want} != want:
            fail(f"tensor parallel: rank {r}'s caption batch launched {c['launches']}, want {want}")
        for dn in ("fp32", "bf16"):
            x, x1, xs = o["xe"][dn], one["xe"][dn], one["xe_split"][dn]
            worst, noise, where = x["update"]
            print(f"[tp] rank {r}: b{TRAIN_BATCH} {dn} XE step loss {x['loss']:.9f} (one process "
                  f"{x1['loss']:.9f}, {rel(x['loss'], x1['loss']):.2e}; computing the ranks' "
                  f"slices {xs['loss']:.9f}, {rel(x['loss'], xs['loss']):.2e}), update "
                  f"{worst:.2e} lr from the latter's ({where}; {x['flips'][0]} of "
                  f"{x['flips'][1]} held elements beyond {UPDATE_TOL:.0e} lr), {noise:.2e} lr "
                  f"where the gradient is noise", flush=True)
            if any(not np.isfinite(x["loss"]) or rel(x["loss"], y) > LOSS_TOL
                   for y in (x1["loss"], xs["loss"])):
                fail(f"tensor parallel: rank {r}'s {dn} XE loss {x['loss']} != one process's "
                     f"{x1['loss']} / {xs['loss']}")
            if not x["replicas_equal"]:
                fail(f"tensor parallel: the ranks' replicated parameters differ after the "
                     f"{dn} step")
            if dn == "fp32" and (worst > UPDATE_TOL or noise > 2):
                fail(f"tensor parallel: rank {r}'s fp32 XE update {worst:.3e} / {noise:.3e} "
                     f"learning rates from one process's ({where})")
            if dn == "bf16" and x["flips"][0] > TP_FLIP_RATIO * xs["again_flips"][0]:
                fail(f"tensor parallel: rank {r}'s bf16 XE update flips {x['flips'][0]} "
                     f"elements against one process's, which flips {xs['again_flips'][0]} "
                     f"against itself")
    ratio = max(outs[0]["errors"][k]["tp2_vs_fp32"] / outs[0]["errors"][k]["one_process_vs_fp32"]
                for k in ("gri", "reg"))
    print(f"[tp] bf16 error against fp32, tp2 over one process's: {ratio:.3f}x at most "
          + ("(within" if ratio <= TP_BF16_RATIO else "(ABOVE") + f" {TP_BF16_RATIO}x: "
          + ("no f32-store epilogue needed)" if ratio <= TP_BF16_RATIO else
             "an f32-store GEMM epilogue is worth queueing)"), flush=True)
    c, o0 = outs[0]["caption"], outs[0]
    med = lambda t: sorted(t)[len(t) // 2]   # noqa: E731
    for what, a, b, coll_a, coll_b in (
            (f"b{TP_BATCH} bf16 caption batch", c1["ms"], c["ms"], c1["collectives"],
             c["collectives"]),
            (f"b{TRAIN_BATCH} bf16 XE step", one["xe"]["bf16"]["ms"], o0["xe"]["bf16"]["ms"],
             one["xe"]["bf16"]["collectives"], o0["xe"]["bf16"]["collectives"])):
        print(f"[tp] {what}: tp1 {med(a):.1f} ms ({', '.join(f'{t:.1f}' for t in a)}), tp2 "
              f"{med(b):.1f} ms ({', '.join(f'{t:.1f}' for t in b)}); all-reduces a rank "
              f"{coll_b['all_reduce']} ({coll_b['all_reduce_bytes'] / 2 ** 20:.1f} MiB), "
              f"all-gathers {coll_b['all_gather']}, broadcasts of the replicated gradients "
              f"{coll_b['broadcast']} ({coll_b['broadcast_bytes'] / 2 ** 20:.1f} MiB) (tp1: "
              f"{coll_a['all_reduce']} collectives)  [{card}]", flush=True)
    for who, p in (("tp1", c1["profile"]), ("tp2 rank 0", c["profile"])):
        # an NCCL kernel spans its wait for the peer: busy counts the rest
        p["busy_ms"] -= p["nccl_kernel_ms"]
        p["idle_share"] = 1 - p["busy_ms"] / p["wall_ms"]
        print(f"[tp] {who} caption batch profiled: device busy {p['busy_ms']:.1f} ms outside the "
              f"collectives' kernels ({p['nccl_kernel_ms']:.2f} ms), idle share "
              f"{p['idle_share']:.3f}, wall {p['wall_ms']:.1f} ms, host copies "
              f"{p['copy_ms']:.2f} ms, host time in the all-reduces {p['allreduce_host_ms']:.1f} "
              f"ms  [{card}]", flush=True)
    RESULTS["K11 partial"]["launches"] = c["launches"]["K11 partial"]
    RESULTS["K11 finish"]["launches"] = c["launches"]["K11 finish"]
    RESULTS["tensor_parallel"] = {
        "backend": backend, "two_cards": two_cards, "one_process_s": ref_s, "ranks_s": ranks_s,
        "bf16_error_ratio": ratio,
        "one_process": {"caption_ms": c1["ms"], "caption_profile": c1["profile"],
                        "caption_launches": c1["launches"], "xe": one["xe"],
                        "xe_split": one["xe_split"]},
        "ranks": [{"rank": o["rank"], "card": o["card"], "errors": o["errors"],
                   "caption_ms": o["caption"]["ms"], "caption_profile": o["caption"]["profile"],
                   "caption_launches": o["caption"]["launches"],
                   "caption_collectives": o["caption"]["collectives"],
                   "xe": o["xe"]}
                  for o in outs]}
    free_card()
    RESULTS["tensor_parallel"]["dryrun"] = dryrun_multichip(4, device=DEV)


def ptxas_report() -> dict:
    """{kernel instance: (registers a thread, spilled bytes)} from the
    ``-Xptxas -v`` lines of each source's build log; an instance is named by
    its kernel's name and its template arguments as mangled (e.g.
    ``gemm_f32_kernel<Li128ELi2ELi8E>``)."""
    import re

    out = {}
    for log in sorted(_cuda.BUILD_DIR.glob("*.log")):
        name = spill = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                mangled, name = m.group(1), m.group(1)
                # walk the length-prefixed identifiers of the (nested) name to
                # the one that ends in _kernel, then its template arguments
                # (I ... E) where it has them
                pos = 3 if mangled.startswith("_ZN") else 2
                while (d := re.match(r"\d+", mangled[pos:])):
                    start = pos + d.end()
                    ident = mangled[start:start + int(d.group())]
                    pos = start + len(ident)
                    if ident.endswith("_kernel"):
                        targs = re.match(r"I(\w*?E)E", mangled[pos:])
                        name = f"{ident}<{targs.group(1)}>" if targs else ident
                        break
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name] = (int(m.group(1)), spill or 0)
                name = spill = None
    return out


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

    # the compiler's register and spill report goes into _build/<source>.log
    _cuda.NVCC_FLAGS = _cuda.NVCC_FLAGS + ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    print(f"[build] kernel library ready in {build_s:.1f} s", flush=True)
    resources = ptxas_report()
    print("[build] registers a thread, spilled bytes (stores + loads) by kernel instance: "
          + "; ".join(f"{k} {r} / {sp}" for k, (r, sp) in resources.items()), flush=True)

    det = dict(stages=DET_STAGES, levels=DET_LEVELS, hw=DET_HW)
    online = dict(stages=ONLINE_STAGES, levels=ONLINE_LEVELS, hw=ONLINE_BUCKET)
    phases = [
        ("kernels", lambda: phase_kernels(args.batch)),
        # the trainer's evaluation batch; the detector's validation; the online
        # evaluation's 640x640 bucket, before phase_decoders_and_entry_points
        # runs its loop there
        ("kernels eval", lambda: phase_kernels(EVAL_BATCH, counted=False)),
        ("kernels detector", lambda: phase_kernels(DET_BATCH, counted=False, **det)),
        ("kernels online", lambda: phase_kernels(ONLINE_BATCH, counted=False, **online)),
        ("train kernels", lambda: phase_train_kernels(TRAIN_BATCH)),
        # the SCST generation and update
        ("train kernels sc", lambda: phase_train_kernels(SC_BATCH, counted=False)),
        ("train kernels detector",
         lambda: phase_train_kernels(DET_BATCH, n_frozen=0, run="detector", **det)),
        ("merge kernels", phase_merge_kernels),
        ("merge kernels online", lambda: phase_merge_kernels(
            paths=(("online", ONLINE_BATCH, ONLINE_STAGES, ONLINE_BUCKET),), counted=False)),
        ("ln kernels", lambda: phase_ln_kernels(card)),
        ("mlp bwd kernels", lambda: phase_mlp_bwd_kernels(card)),
        ("dense attention kernel", lambda: phase_dense_attention_kernel(args.batch)),
        ("decode kernel", phase_decode_kernel),
        ("tp kernels", phase_tp_kernels),
        ("moe experts", lambda: phase_moe_experts(card)),
        ("msda kernels", phase_msda_kernels),
        ("adam kernel", phase_adam_kernel),
        ("lsa kernel", phase_lsa_kernel),
        ("yardsticks caption", lambda: phase_yardsticks("caption", args.batch, STAGES,
                                                        len(STAGES))),
        ("yardsticks train", lambda: phase_yardsticks("train", TRAIN_BATCH, STAGES,
                                                      FROZEN_STAGES - 1)),
        ("yardsticks detector", lambda: phase_yardsticks("detector", DET_BATCH, DET_STAGES, 0)),
        ("slice", lambda: phase_slice(args.batch, card)),
        ("slice b128", lambda: phase_slice_b128(card)),
        ("decode graph", lambda: phase_decode_graph(card)),
        ("parity", lambda: phase_parity(args.batch)),
        ("train", lambda: phase_train(card)),
        ("native metrics", phase_native_metrics),
        ("trainer", lambda: phase_trainer(card)),
        ("decoders and entry points", lambda: phase_decoders_and_entry_points(card)),
        ("detector fp32", lambda: phase_detector(card, torch.float32)),   # the CLI's type
        ("detector bf16", lambda: phase_detector(card, torch.bfloat16)),
        # the other Swin presets: their kernels' shapes, then their paths
        ("presets kernels", phase_preset_kernels),
        ("presets yardsticks", phase_preset_yardsticks),
        ("presets caption", lambda: [phase_preset_slice(name, card) for name in PRESETS]),
        ("presets parity", lambda: [phase_preset_parity(name) for name in ("swin_tiny", LARGE)]),
        ("presets train", lambda: [phase_preset_train(name, card)
                                   for name in ("swin_small", LARGE)]),
        ("presets detector fp32", lambda: phase_detector(
            card, torch.float32, backbone="swin_tiny", full=False)),
        ("presets detector bf16", lambda: phase_detector(
            card, torch.bfloat16, backbone="swin_tiny", full=False)),
        ("presets train parity", lambda: phase_train_parity(
            PRESET_PARITY_BATCH, preset_config("swin_tiny"), "swin_tiny")),
        ("tools", phase_tools),
        ("data parallel", lambda: phase_data_parallel(card, args.profile)),
        ("tensor parallel", lambda: phase_tensor_parallel(card)),
        ("profile", lambda: phase_profile(args.batch, card) if args.profile else None),
        ("train parity", lambda: phase_train_parity(TRAIN_BATCH)),
        ("parity seeds", lambda: parity_seeds(TRAIN_BATCH, args.parity_seeds)),
        ("detector parity", lambda: phase_detector_parity(DET_PARITY_BATCH)),
    ]
    seconds = {}
    for name, run_phase in phases:
        t0 = time.perf_counter()
        run_phase()
        seconds[name] = time.perf_counter() - t0
        print(f"[time] {name}: {seconds[name]:.1f} s", flush=True)

    csrc = "grit_tpu_torch/csrc/"
    swin, msda = csrc + "swin_block.cu", csrc + "msda.cu"
    jwa, jmsda = "grit_tpu/ops/window_attention.py", "grit_tpu/ops/msda_pallas.py"
    per = {"caption": f"b{args.batch} bf16 caption forward",
           "train": f"b{TRAIN_BATCH} bf16 XE training step",
           "detector": f"b{DET_BATCH} bf16 detector training step at {DET_HW[0]}x{DET_HW[1]}"}
    fp32_kernels = ("gemm_f32", "win_attn_f32", "win_attn_bwd_f32")
    # name: (source, TPU kernel it replaces, the run its launches, ms and bound are of)
    sources = {"K1": (swin, jwa + ":1029", "caption"), "K2": (swin, jwa + ":1819", "caption"),
               "K3": (msda, jmsda + ":1018", "caption"), "K4": (swin, jwa + ":385", "train"),
               "K5": (swin, jwa + ":197", "train"), "K6": (msda, jmsda + ":633", "train"),
               "K10a": (swin, jwa + ":1985", "caption"), "K10b": (swin, jwa + ":2081", "caption"),
               "K11": (csrc + "decode_layer.cu", "grit_tpu/ops/decode_layer.py:117", "caption"),
               # the two kernels inside K1, K2, K4, K8 and K10a (each TPU body
               # above holds its own products and attention)
               "gemm_bf16": (csrc + "gemm_sm90.cu", jwa + ":1029", "caption"),
               "win_attn": (csrc + "window_attn_mma.cu", jwa + ":1029", "caption"),
               # the attention backward inside K5 and K8's gradient
               "win_attn_bwd": (csrc + "win_attn_bwd_mma.cu", jwa + ":197", "train"),
               # the fp32 kernels, of the detector step in fp32 (the CLI's type)
               "gemm_f32": (swin, jwa + ":1029", "detector"),
               "win_attn_f32": (csrc + "win_attn_f32.cu", jwa + ":1029", "detector"),
               "win_attn_bwd_f32": (csrc + "win_attn_f32.cu", jwa + ":197", "detector")}
    serves = {"gemm_bf16": "K1, K2, K4, K10a", "win_attn": "K1, K4, K8",
              "win_attn_bwd": "K5, K8", "gemm_f32": "K1, K2, K4, K10a (fp32)",
              "win_attn_f32": "K1, K4, K8 (fp32)", "win_attn_bwd_f32": "K5, K8 (fp32)"}
    launch_key = {"caption": "launches", "train": "launches_train",
                  "detector": "launches_detector"}
    kernels = []
    for k, (src, rep, run) in sources.items():
        r = RESULTS[k]
        acc = r[run]
        row = {"name": k, "route": "cuda", "source": src, "replaces": rep,
               "launches": r[launch_key[run]], "max_abs_err": r["max_abs_err"],
               "ms": acc["ms"], "plain_ms": acc["plain_ms"],
               "bound_ms": max(acc["bytes_ms"], acc["ops_ms"]),
               "bound_by": "bytes" if acc["bytes_ms"] >= acc["ops_ms"] else "operations",
               # one PyTorch call computes K10a's rows (F.layer_norm + F.linear
               # after the gather) and K10b (F.layer_norm); none computes the
               # others whole: their parts' yardsticks (and the module path of
               # K11's tail) are in chip_smoke.json
               "library_ms": acc["library_ms"] or None,
               "per": per[run].replace("bf16", "fp32") if k in fp32_kernels else per[run],
               "launches_trainer": r.get("launches_trainer", 0)}
        # the same numbers for each of the three runs, whichever the keys above are of
        for other in RUNS:
            o = r[other]
            row.update({f"launches_{other}": r.get(launch_key[other], 0),
                        f"{other}_ms": o["ms"], f"{other}_plain_ms": o["plain_ms"],
                        f"{other}_bound_ms": max(o["bytes_ms"], o["ops_ms"]),
                        f"{other}_library_ms": o["library_ms"] or None})
        if k in serves:
            row["serves"] = serves[k]
        kernels.append(row)
    r = RESULTS["K8"]
    kernels.append({
        "name": "K8", "route": "cuda", "source": swin, "replaces": jwa + ":57",
        # no model path of either package reaches K8: its kernel phase holds it
        "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": max(r["bound_bytes_ms"], r["bound_ops_ms"]),
        "bound_by": "bytes" if r["bound_bytes_ms"] >= r["bound_ops_ms"] else "operations",
        "library_ms": r["library_ms"],
        "per": f"one bf16 forward at each of the four Swin stage shapes of a b{args.batch} "
               f"{HW[0]}x{HW[1]} batch, a bias over every window",
        "bwd_ms": r["bwd_ms"], "bwd_plain_ms": r["bwd_plain_ms"], "bwd_bound_ms": r["bwd_bound_ms"],
        "bwd_library_ms": r["bwd_library_ms"],
        "kernel_phase_launches": r["kernel_phase_launches"]})
    r = RESULTS["K12"]
    kernels.append({
        "name": "K12", "route": "cuda", "source": csrc + "adam.cu",
        "replaces": "grit_tpu/ops/fused_adam.py:143", "launches": r["launches_train"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r["library_ms"],
        "per": f"b{TRAIN_BATCH} bf16 XE training step (one update of {r['elements']} elements)",
        "launches_caption": 0, "launches_train": r["launches_train"],
        "launches_trainer": r["launches_trainer"],
        "launches_detector": r["launches_detector"], "train_ms": r["ms"],
        "train_plain_ms": r["plain_ms"], "train_bound_ms": r["bound_ms"],
        "detector_ms": RESULTS["detector_bf16"]["adam_ms"],
        "detector_bound_ms": RESULTS["detector_bf16"]["adam_bound_ms"]})
    # K11's tensor-parallel split: the two entries a tp2 rank's decode step
    # launches (the partial mode of grit_decode_tail's chain, then the finish)
    for k, entry in (("K11 partial", "grit_decode_tail, partial mode (launches 1-7)"),
                     ("K11 finish", "grit_decode_tail_finish (launch 9)")):
        r = RESULTS[k]
        acc = r["caption"]
        kernels.append({
            "name": k, "route": "cuda", "source": csrc + "decode_layer.cu",
            "replaces": "grit_tpu/ops/decode_layer.py:117", "entry": entry,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": max(acc["bytes_ms"], acc["ops_ms"]),
            "bound_by": "bytes" if acc["bytes_ms"] >= acc["ops_ms"] else "operations",
            "library_ms": None,
            "per": f"one rank's b{TP_BATCH} bf16 caption forward, the decoder's FFNs split over "
                   f"tp2 ({D_FF // 2} of d_ff {D_FF} a rank)"})
    # the matcher: no Pallas body; it ports the JAX solver's lax control flow
    r, step_row = RESULTS["lsa"], RESULTS["detector_bf16"]["matcher"]["lsa"]
    kernels.append({
        "name": "grit_lsa", "route": "cuda", "source": csrc + "lsa.cu",
        "replaces": "grit_tpu/detection/losses.py:96",
        "note": "no Pallas counterpart: ports _device_lsa_single (lax control flow)",
        "launches": r["launches_detector"], "max_abs_err": 0, "ms": step_row["ms"],
        "plain_ms": step_row["plain_ms"], "bound_ms": step_row["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "host_path_ms": step_row["host_ms"],
        "per": f"one b{DET_BATCH} bf16 detector step's matching ({step_row['problems']} "
               f"problems x queries x boxes)",
        "iterations": step_row["iterations"], "ns_per_iteration": step_row["ns_per_iteration"],
        "synthetic": {k: {f: r[k][f] for f in LSA_ROW_KEYS} for k in ("continuous", "integer")},
        "fp32_step": {f: RESULTS["detector_fp32"]["matcher"]["lsa"][f] for f in LSA_ROW_KEYS}})
    # TPU bodies that one GPU kernel serves, with the cases that kernel was
    # checked at: the S-chunked MSDA pair (K7a, K7b) and the first-generation
    # MSDA bodies (K13a-d) at the 832x1344 pyramid, K1's other layout (K9) at
    # the 832x1344 stage maps
    det_tag = f"{DET_HW[0]}x{DET_HW[1]}"
    mapped = [{"name": name, "maps_onto": onto, "replaces": rep, "checked": [
                   c for c in DETAIL if c["kernel"] == onto and det_tag in c["case"]]}
              for name, onto, rep in (("K7a", "K3", jmsda + ":1259"), ("K7b", "K6", jmsda + ":1324"),
                                      ("K9", "K1", jwa + ":751"), ("K13a", "K3", jmsda + ":144"),
                                      ("K13b", "K6", jmsda + ":189"), ("K13c", "K3", jmsda + ":235"),
                                      ("K13d", "K3", jmsda + ":579"))]
    if not all(m["checked"] for m in mapped):
        fail(f"a mapped kernel has no check at the {det_tag} shapes")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "build_s": build_s,
                   "ptxas": resources,
                   "kernels": kernels,
                   "mapped": mapped, "yardsticks": YARDSTICKS, "cases": DETAIL,
                   "msda_phase": RESULTS.get("msda_phase"),
                   "slice": RESULTS.get("slice"), "slice_b128": RESULTS.get("slice_b128"),
                   "decode_graph": RESULTS.get("decode_graph"),
                   "train": RESULTS.get("train"),
                   "trainer": RESULTS.get("trainer"),
                   "detector_fp32": RESULTS.get("detector_fp32"),
                   "detector_bf16": RESULTS.get("detector_bf16"),
                   "detector_parity": RESULTS.get("detector_parity"),
                   "train_parity": RESULTS.get("train_parity"),
                   "parity_seeds": RESULTS.get("parity_seeds"),
                   "ln_kernels": RESULTS.get("ln_kernels"),
                   "decoders": RESULTS.get("decoders"),
                   "data_parallel": RESULTS.get("data_parallel"),
                   "tensor_parallel": RESULTS.get("tensor_parallel"),
                   "lsa": RESULTS.get("lsa"), "native_metrics": RESULTS.get("native_metrics"),
                   "moe_experts": RESULTS.get("moe_experts"),
                   "presets": {k: v for k, v in RESULTS.items()
                               if any(k.startswith(p) for p in ("slice swin", "train swin",
                                                                "detector_fp32 swin",
                                                                "detector_bf16 swin",
                                                                "train_parity swin"))},
                   "phase_seconds": seconds}, f, indent=1)
    # in the printed line a mapped body carries its kernel's launches on that
    # kernel's run and the numbers of one bf16 check at the 832x1344 shapes
    by_name = {k["name"]: k for k in kernels}
    for m in mapped:
        onto = by_name[m["maps_onto"]]
        case = next(c for c in m["checked"] if c["case"].startswith("bf16") and "bytes_ms" in c)
        kernels.append({
            "name": m["name"], "route": "cuda", "source": onto["source"],
            "replaces": m["replaces"], "maps_onto": m["maps_onto"], "launches": onto["launches"],
            "max_abs_err": max(c["max_abs_err"] for c in m["checked"]), "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": max(case["bytes_ms"], case["ops_ms"]),
            "bound_by": "bytes" if case["bytes_ms"] >= case["ops_ms"] else "operations",
            "library_ms": None, "per": f"one call of {m['maps_onto']}: {case['case']}",
            f"checks_at_{det_tag}": len(m["checked"])})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
