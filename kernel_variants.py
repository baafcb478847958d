"""Time variants of the Hopper kernels' sources side by side on one card.

  python3 kernel_variants.py                  # every variant
  python3 kernel_variants.py swin_block.cu    # the variants of the named sources
  python3 kernel_variants.py ln               # swin_block.cu's LayerNorm group alone
  python3 kernel_variants.py --csrc DIR --label parent lsa.cu
                                              # another checkout's sources (e.g. the
                                              # parent commit's), results named by label
  python3 kernel_variants.py --parent DIR ln  # also DIR's sources as they are, as the
                                              # variant "parent", timed in turn with the rest

A tool for finding where a Hopper kernel's time goes: each variant is a
source under grit_tpu_torch/csrc with text substitutions, compiled by its own
nvcc (all at once) into a library with a small C entry point, and timed as
device time by CUDA-graph replay beside the source as it is and the PyTorch
call for the same function, at the shapes of a b8 384x640 caption forward
(each shape's time weighted by its launches in the forward).  The variants:

  gemm_sm90.cu, every product in its bias epilogue: as it is; the main loop
    alone (the tile is never stored); beside F.linear.
  window_attn_mma.cu, K1's core: as it is; with an IEEE division for each
    probability in place of one reciprocal a row; beside
    scaled_dot_product_attention with an additive mask.
  win_attn_f32.cu, the fp32 core at the shapes of a b4 832x1344 detector
    step (K4's, both shifts): as it is; with an IEEE division for each
    probability; one block an SM; beside scaled_dot_product_attention in fp32
    with an additive mask; each variant's outputs checked within 2e-5 of the
    first's (of its max).  And its fp32 backward at the same shapes, the
    batch split as the wrapper splits it: as it is; without the bias
    gradient's stores; with the rows loaded for a chunk's first image only
    (both cut parts out, so their outputs are not checked).
  swin_block.cu's fp32 GEMM, every product in its bias epilogue at the shapes
    of a b4 832x1344 detector step (the fp32 CLI's): as it is; with 8-deep
    k steps; one block an SM; the main loop alone; beside F.linear in fp32;
    each variant's outputs checked equal to the first's bit for bit (every
    variant keeps the fmaf chain of each output).
  swin_block.cu's LayerNorm kernels (the "ln" group: ln_rows_kernel and
    ln_merge_kernel) through their C entries grit_ln_rows and grit_ln_merge
    at each shape of chip_smoke.phase_ln_kernels (chip_smoke.LN_RUNS and
    ln_cases: the b8 and b128 caption forwards in bf16, the b4 832x1344
    detector step in fp32 and bf16, an odd map): as it is; at most 4
    chunks a lane where rows are read in place (row mode), 2 where they are
    gathered (window mode, the merge); up to 512 lanes a row; 256 threads a
    block; beside F.layer_norm on the same rows; each shape's time the
    median of three graph replays, each variant's outputs checked within
    chip_smoke.TOL of the plain version's (and, with --parent, compared bit
    for bit with the parent's), and each run's sums over its launches by
    kernel.  With
    --csrc on another checkout (e.g. the parent commit's), its "as is" runs
    at the same shapes and its other forms are not built; with --parent it
    runs as the variant "parent" in the same process, each shape's
    variants timed in turns (three rounds).

  decode_layer.cu, K11 (the decode-layer tail, eight launches) through its
    wrapper at the decode shapes of a b8, a b16 and a b128 caption batch
    (40, 80 and 640 rows, beam 5, 60 + 150 keys, masks), bf16 and fp32: as it
    is; 8-column product tiles at 640 rows too; 16-column ones there; 128
    threads an attention block; the gates' and fc2's K not split over a
    cluster of blocks, or split over 4; each variant's outputs checked
    within 2e-5 (fp32) / 3e-2 (bf16) of the first's max (a variant may sum
    in another order).

  msda.cu, K3 (MSDA forward) and K6 (its backward) through their C entries
    at a b16 XE step's and a b128 caption batch's MSDA (K6 without the
    wrapper's zero-fill and casts), bf16 and fp32: as it is; 2 channels a
    lane (a warp a head); every corner loaded (an invalid one zeroed
    after) in place of behind a branch; 2 taps in
    flight; K6 at one block an SM; K6 with scalar atomics in place of vector
    ones; K6 without its value-gradient scatter (its dvalue not checked);
    each variant's outputs checked within 2e-5 (fp32) / 3e-2 (bf16) of the
    first's max.

  lsa.cu, grit_lsa (the detector's matcher) through its C entry at a b4
    detector step's problems ([28, 150, 100], the fills cycling through
    chip_smoke.LSA_FILLS), continuous and integer costs: as it is; staging
    alone (the kernel returns once the costs are in shared memory); no
    potential updates (u, v and minv never move by delta: the picks, and so
    the iterations, may differ, so it shows the updates' share only
    roughly); and the warp design's choices on an iteration's chain: the
    next row loaded after the updates, the lane's minimum by a tree, the
    first column's row and u picked with it, the lowest lane by a second
    reduction, delta by a shuffle.  Every variant but the two cut ones is
    checked equal to the plain version's assignments.  A variant's text may
    have one form for each design of the source (the block design of the
    parent commit, the warp design): the first form whose texts all occur
    is built, and a variant no form of which fits is not.

Prints one line per kernel and writes chiprun_out/kernel_variants.json.
Needs a card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from grit_tpu_torch.ops import _cuda
from grit_tpu_torch.ops.window_attention import bwd_batch_chunks

OUT_ROOT = Path("chiprun_out")
# the b8 384x640 Swin-B stages: (C, heads, padded map (Hp, Wp), blocks)
STAGES = ((128, 4, (96, 168), 2), (256, 8, (48, 84), 2), (512, 16, (24, 48), 18),
          (1024, 32, (12, 24), 2))
BATCH, WINDOW = 8, 12
# the b4 832x1344 detector step's stages, every one training
DET_STAGES = ((128, 4, (216, 336), 2), (256, 8, (108, 168), 2), (512, 16, (60, 84), 18),
              (1024, 32, (36, 48), 2))
DET_BATCH = 4
SHIMS = {
    "gemm_sm90.cu": r'''
#include "common.cuh"
extern "C" int variant_entry(const void* A, const void* W, const void* bias, void* out, int M,
                             int N, int K, void* st) {
  grit::Epi e{bias, out, nullptr, grit::EPI_BIAS, 1.0f, 0, grit::WinMap{1, 1, 1, 0, 1, 1}, 0};
  return grit::launch_gemm_bf16((const grit::bf16*)A, (const grit::bf16*)W, M, N, K, e,
                                (cudaStream_t)st);
}
''',
    "swin_block.cu": r'''
#include "common.cuh"
namespace grit {  // the other sources' launchers, not built into the variant
int launch_gemm_bf16(const bf16*, const bf16*, int, int, int, const Epi&, cudaStream_t) {
  return 1;
}
int launch_win_attn_bf16(const bf16*, const bf16*, const bf16*, size_t, float, const float*,
                         const float*, int, bf16*, int, int, int, WinMap, cudaStream_t) {
  return 1;
}
int launch_win_attn_bwd_bf16(const bf16*, const bf16*, const bf16*, const bf16*, size_t, float,
                             float, const float*, const float*, int, bf16*, bf16*, bf16*, float*,
                             int, int, int, int, WinMap, cudaStream_t) {
  return 1;
}
int launch_win_attn_f32(const float*, const float*, const float*, size_t, float, const float*,
                        const float*, int, float*, int, int, int, WinMap, cudaStream_t) {
  return 1;
}
int launch_win_attn_bwd_f32(const float*, const float*, const float*, const float*, size_t, float,
                            float, const float*, const float*, int, float*, float*, float*, float*,
                            int, int, int, int, WinMap, cudaStream_t) {
  return 1;
}
}  // namespace grit
extern "C" int grit_gemm(const void*, const void*, const void*, void*, const void*, int, int,
                         int, int, float, int, int, int, int, int, int, int, int, int, void*);
extern "C" int variant_entry(const void* A, const void* W, const void* bias, void* out, int M,
                             int N, int K, void* st) {
  return grit_gemm(A, W, bias, out, nullptr, M, N, K, grit::EPI_BIAS, 1.0f, 0, 1, 1, 1, 0, 1, 1,
                   0, 0, st);
}
''',
    "window_attn_mma.cu": r'''
#include "common.cuh"
extern "C" int variant_entry(const void* qkv, const void* table, void* out, int nw, int C,
                             int heads, int Hp, int Wp, int win, int shift, void* st) {
  grit::WinMap m{Hp, Wp, win, shift, Hp, Wp};
  const grit::bf16* q = (const grit::bf16*)qkv;
  return grit::launch_win_attn_bf16(q, q + C, q + 2 * C, 3 * (size_t)C, 1.0f,
                                    (const float*)table, nullptr, 1, (grit::bf16*)out, nw, C,
                                    heads, m, (cudaStream_t)st);
}
''',
    "win_attn_f32.cu": r'''
#include "common.cuh"
extern "C" int variant_entry(const void* qkv, const void* table, void* out, int nw, int C,
                             int heads, int Hp, int Wp, int win, int shift, void* st) {
  grit::WinMap m{Hp, Wp, win, shift, Hp, Wp};
  const float* q = (const float*)qkv;
  return grit::launch_win_attn_f32(q, q + C, q + 2 * C, 3 * (size_t)C, 1.0f, (const float*)table,
                                   nullptr, 1, (float*)out, nw, C, heads, m, (cudaStream_t)st);
}
extern "C" int variant_bwd_entry(const void* qkv, const void* dout, const void* table,
                                 void* dqkv, void* dbias, int batch, int chunks, int C, int heads,
                                 int Hp, int Wp, int win, int shift, void* st) {
  grit::WinMap m{Hp, Wp, win, shift, Hp, Wp};
  const float* q = (const float*)qkv;
  float* dq = (float*)dqkv;
  return grit::launch_win_attn_bwd_f32(q, q + C, q + 2 * C, (const float*)dout, 3 * (size_t)C,
                                       1.0f, 0.17677669529663687f, (const float*)table, nullptr,
                                       1, dq, dq + C, dq + 2 * C, (float*)dbias, batch, chunks, C,
                                       heads, m, (cudaStream_t)st);
}
''',
    # the variant library exports grit_decode_tail (grit_msda, grit_msda_bwd) itself
    "decode_layer.cu": "\n",
    "msda.cu": "\n",
    "lsa.cu": "\n",
}
# swin_block.cu's LayerNorm variants, named "ln: ..." (one form each: a
# checkout with another LayerNorm design builds none of them)
LN_VARIANTS = [("ln: " + name, [[(old, new)]]) for name, old, new in (
    ("rows in place 4 chunks a lane", "LN_CHUNKS_ROWS = 2;", "LN_CHUNKS_ROWS = 4;"),
    ("gathered rows 2 chunks a lane", "LN_CHUNKS_GATHER = 4;", "LN_CHUNKS_GATHER = 2;"),
    ("512 lanes a row", "LN_MAX_LANES = 256;", "LN_MAX_LANES = 512;"),
    ("256 threads a block", "LN_THREADS = 128;", "LN_THREADS = 256;"))]
# grit_lsa's warp design: the next iteration's row loads
LSA_NEXT_ROW = ("#pragma unroll\n      for (int k = 0; k < C; ++k) x[k] = cols[(size_t)max(p1, 0) * Q"
                " + k];\n")
# (source, variant name, [(text, replacement), ...]); or, for a source with
# more than one design, a list of such lists: the first whose texts all occur
VARIANTS = [
    ("gemm_sm90.cu", "as is", []),
    ("gemm_sm90.cu", "main loop alone", [
        ("  wgmma_wait<0>();\n  fence_acc(acc);\n",
         "  wgmma_wait<0>();\n  fence_acc(acc);\n  if (M > 0) return;\n")]),
    ("window_attn_mma.cu", "as is", []),
    ("window_attn_mma.cu", "a division per probability", [
        (" * ra,", " / suma,"), (" * ra);", " / suma);"), (" * rb,", " / sumb,"),
        (" * rb);", " / sumb);")]),
    ("win_attn_f32.cu", "as is", []),
    ("win_attn_f32.cu", "a division per probability", [
        ("rs[r] = 1.0f / sum;", "rs[r] = sum;"), (" * rs[", " / rs[")]),
    ("win_attn_f32.cu", "one block an SM", [("NS <= 9 ? 2 : 1", "1")]),
    # the backward with a part cut out (its outputs then differ: timed only)
    ("win_attn_f32.cu", "backward: no bias-gradient stores", [
        ("      if (idx < n * n4) {", "      if (idx < n * n4 && batch < 0) {")]),
    ("win_attn_f32.cu", "backward: rows loaded for the first image only", [
        ("    load_rows<NP>(Qs, src, stride, 4, row0", "    if (bi == b_begin) load_rows<NP>(Qs, src, stride, 4, row0")]),
    ("decode_layer.cu", "as is", []),
    ("decode_layer.cu", "8-column tiles at every row count", [
        ("PR_WIDE_ROWS = 128", "PR_WIDE_ROWS = 1 << 30")]),
    ("decode_layer.cu", "16-column tiles past 128 rows", [("PR_WIDE_NF = 4", "PR_WIDE_NF = 2")]),
    ("decode_layer.cu", "128 attention threads", [("AT_THREADS = 256", "AT_THREADS = 128")]),
    ("decode_layer.cu", "no K split over a cluster", [("PR_SPLIT = 2", "PR_SPLIT = 1")]),
    ("decode_layer.cu", "K split over 4 blocks", [("PR_SPLIT = 2", "PR_SPLIT = 4")]),
    ("msda.cu", "as is", []),
    ("msda.cu", "2 channels a lane", [("MS_VEC = 4;", "MS_VEC = 2;")]),
    ("msda.cu", "branch-free corner loads", [(
        "  if (o >= 0) {\n    load_vec(vb + o, v);\n  } else {\n#pragma unroll\n"
        "    for (int c = 0; c < MS_VEC; ++c) v[c] = 0.0f;\n  }\n",
        "  load_vec(vb + max(o, 0), v);\n#pragma unroll\n"
        "  for (int c = 0; c < MS_VEC; ++c) v[c] = o >= 0 ? v[c] : 0.0f;\n")]),
    ("msda.cu", "2 taps in flight", [("MS_UNROLL = 4;", "MS_UNROLL = 2;")]),
    ("msda.cu", "backward: one block an SM", [
        ("__launch_bounds__(MS_THREADS, 2) msda_bwd_kernel",
         "__launch_bounds__(MS_THREADS) msda_bwd_kernel")]),
    ("msda.cu", "backward: scalar atomics", [(
        "    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));",
        "    for (int c = 0; c < 4; ++c) atomicAdd(p + c, v[c]);")]),
    # cuts the value gradient out: its dvalue is not checked
    ("msda.cu", "backward: no value-gradient scatter", [
        ("          red_vec(db + o, d);", "          (void)d;")]),
    ("swin_block.cu", "as is", []),
    ("swin_block.cu", "k step 8", [("GF_BK = 16", "GF_BK = 8")]),
    ("swin_block.cu", "one block an SM", [
        ("__launch_bounds__(256, 2) gemm_f32_kernel", "__launch_bounds__(256, 1) gemm_f32_kernel")]),
    ("swin_block.cu", "main loop alone", [
        ("    if (row >= M) continue;\n#pragma unroll\n    for (int q = 0; q < TQ; ++q) {",
         "    if (row >= M || K > 0) continue;\n#pragma unroll\n    for (int q = 0; q < TQ; ++q) {")]),
    *(("swin_block.cu", name, subs) for name, subs in LN_VARIANTS),
    ("lsa.cu", "as is", []),
    ("lsa.cu", "staging alone", [
        [("  __syncthreads();\n  if (threadIdx.x >= 32) return;",
          "  __syncthreads();\n  if (G > 0) return;\n  if (threadIdx.x >= 32) return;")],
        [("  __syncthreads();   // before thread 0 sets p[Q] for row 0\n",
          "  __syncthreads();   // before thread 0 sets p[Q] for row 0\n  if (G > 0) return;\n")]]),
    ("lsa.cu", "no potential updates", [
        [("        if ((used >> k) & 1u) {\n          uc[k] += delta;\n          v[k] -= delta;\n"
          "        } else {\n          minv[k] -= delta;\n        }\n", ""),
         ("      ucur += delta;\n", "")],
        [("      if (col) {\n        if (used) {\n          u[p[tid]] += delta;\n"
          "          v -= delta;\n        } else {\n          minv -= delta;\n        }\n      }\n"
          "      if (tid == 0) u[i] += delta;", "")]]),
    # the warp design's choices on the iteration's chain (outputs checked)
    ("lsa.cu", "next row loaded after the updates", [[
        (LSA_NEXT_ROW, ""), ("      ucur += delta;\n", "      ucur += delta;\n" + LSA_NEXT_ROW)]]),
    ("lsa.cu", "lane minimum by a tree", [[(
        "      for (int k = 1; k < C; ++k) lmin = fminf(lmin, bv[k]);\n",
        "      for (int k = 0; k < C; ++k) t[k] = bv[k];\n#pragma unroll\n"
        "      for (int s = 1; s < C; s *= 2)\n#pragma unroll\n"
        "        for (int k = 0; k + s < C; k += 2 * s) t[k] = fminf(t[k], t[k + s]);\n"
        "      lmin = t[0];\n"), ("      float lmin = bv[0];\n", "      float lmin, t[C];\n")]]),
    ("lsa.cu", "first column's row and u picked with it", [[
        ("      int kb = C - 1;\n#pragma unroll\n"
         "      for (int k = C - 1; k >= 0; --k) kb = bv[k] == lmin ? k : kb;\n",
         "      int kb = 0, pb = pc[0];\n      float ub = uc[0];\n#pragma unroll\n"
         "      for (int k = C - 1; k >= 0; --k)\n        if (bv[k] == lmin) {\n          kb = k;\n"
         "          pb = pc[k];\n          ub = uc[k];\n        }\n"),
        ("pick(pc, kb)", "pb"), ("pick(uc, kb)", "ub")]]),
    ("lsa.cu", "lowest lane by a second reduce", [[(
        "__ffs(__ballot_sync(FULL, key == wmin)) - 1", "__reduce_min_sync(FULL, key == wmin ? lane : 32)")]]),
    ("lsa.cu", "delta by a shuffle", [[(
        "const float delta = key_value(wmin);", "const float delta = __shfl_sync(FULL, lmin, src);")]]),
]
# grit_lsa's variants that cut a part out: timed only, their outputs not checked
LSA_CUT = {"staging alone", "no potential updates"}


def _options(argv: list[str]) -> tuple[Path, str, Path | None, set]:
    """(source directory, label, the parent's source directory or None,
    selected sources) from the command line."""
    csrc, label, parent, rest = _cuda.CSRC, "", None, []
    args = iter(argv)
    for a in args:
        if a == "--csrc":
            csrc = Path(next(args)).resolve()
        elif a == "--label":
            label = next(args)
        elif a == "--parent":
            parent = Path(next(args)).resolve()
        else:
            rest.append(a)
    return csrc, label, parent, set(rest)


CSRC, LABEL, PARENT, SELECTED = _options(sys.argv[1:])
SUFFIX = f"_{LABEL}" if LABEL else ""


def is_ln(src: str, name: str) -> bool:
    """A variant that the LayerNorm group times: swin_block.cu as it is (or
    the parent's), or an "ln: ..." one."""
    return src == "swin_block.cu" and (name in ("as is", "parent") or name.startswith("ln:"))


def selected(src: str, name: str) -> bool:
    """Whether the command line selects a variant: every one without names;
    a source's all; "ln" the LayerNorm group's."""
    return not SELECTED or src in SELECTED or ("ln" in SELECTED and is_ln(src, name))


def graph_ms(fn, reps: int = 10) -> float:
    """Device milliseconds of one call of ``fn`` (CUDA-graph replay)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def build() -> list:
    """Compile every variant; returns [(source, name, library)]."""
    out = OUT_ROOT / f"kernel_variants{SUFFIX}"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    # with --parent, each source as it is in the parent's directory too
    entries = [(src, name, subs, CSRC) for src, name, subs in VARIANTS]
    if PARENT:
        entries += [(src, "parent", [], PARENT) for src, name, _ in VARIANTS if name == "as is"]
    for i, (src, name, subs, csrc) in enumerate(entries):
        if not selected(src, name):
            continue
        text = (csrc / src).read_text()
        if subs and isinstance(subs[0], list):   # one form a design: the first that fits
            fits = [form for form in subs if all(old in text for old, _ in form)]
            if not fits:   # a variant of another design of the source
                print(f"{src} / {name}: not built, no form of it fits {csrc / src}", flush=True)
                continue
            subs = fits[0]
        for old, new in subs:
            if text.count(old) < 1:
                raise RuntimeError(f"{src} / {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu, shim, lib = out / f"v{i}.cu", out / f"v{i}_entry.cu", out / f"v{i}.so"
        cu.write_text(text)
        shim.write_text(SHIMS[src])
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(lib),
               str(cu), str(shim)]
        jobs.append((src, name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    built = []
    for src, name, lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} / {name}:\n{log[-4000:]}")
        built.append((src, name, ctypes.CDLL(str(lib))))
    for src, _, lib in built:
        exports = {"decode_layer.cu": ("grit_decode_tail",),
                   "msda.cu": ("grit_msda", "grit_msda_bwd"), "lsa.cu": ("grit_lsa",)}
        if src in exports:
            for fn in exports[src]:
                getattr(lib, fn).argtypes = _cuda._SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
            continue
        if src == "swin_block.cu":   # the LayerNorm group calls the C entries
            for fn in ("grit_ln_rows", "grit_ln_merge"):
                getattr(lib, fn).argtypes = _cuda._SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        n_ptr = 4 if src in ("gemm_sm90.cu", "swin_block.cu") else 3
        lib.variant_entry.argtypes = ([ctypes.c_void_p] * n_ptr
                                      + [ctypes.c_int] * (3 if n_ptr == 4 else 7)
                                      + [ctypes.c_void_p])
        lib.variant_entry.restype = ctypes.c_int
        if src == "win_attn_f32.cu":
            lib.variant_bwd_entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            lib.variant_bwd_entry.restype = ctypes.c_int
    return built


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class _TailLib:
    """The kernel library as ``ops/decode_layer.py`` sees it, with one
    variant's ``grit_decode_tail``."""

    def __init__(self, lib):
        self.grit_decode_tail = lib.grit_decode_tail


def decode_tail_variants(built: list, totals: dict, close: dict) -> None:
    """K11's variants through its wrapper at 40, 80 and 640 rows, both types."""
    from grit_tpu_torch.models.cap_generator import ParallelAttentionLayer
    from grit_tpu_torch.models.captioner import to_compute_dtype
    from grit_tpu_torch.ops import decode_layer as tail_ops

    libs = [(name, lib) for src, name, lib in built if src == "decode_layer.cu"]
    if not libs:
        return
    d_model, heads, d_ff, beam, keys = 512, 8, 2048, 5, (60, 150)
    g = torch.Generator(device="cuda").manual_seed(3)
    saved = _cuda._lib
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        layer = ParallelAttentionLayer(d_model, heads, d_ff).to("cuda").eval()
        with torch.no_grad():
            for name, prm in layer.named_parameters():
                scale = prm.shape[-1] ** -0.5 if prm.dim() == 2 else 0.1
                prm.copy_(torch.randn(prm.shape, generator=g, device="cuda") * scale
                          + ("layer_norm" in name and name.endswith("weight")))
        to_compute_dtype(layer, dtype)
        weights = layer.tail_weights(dtype)
        for batch in (8, 16, 128):
            rows = batch * beam
            x = torch.randn(rows, 1, d_model, generator=g, device="cuda").to(dtype)
            kv = [torch.randn(batch, t, d_model, generator=g, device="cuda").to(dtype)
                  for t in (keys[0], keys[0], keys[1], keys[1])]
            masks = [((torch.arange(t, device="cuda")[None] >= t * 3 // 4)
                      & (torch.arange(batch, device="cuda")[:, None] % 2 == 1))[:, None, None]
                     for t in keys]
            pad = (torch.arange(rows, device="cuda") % 2 == 0).to(dtype)[:, None, None]

            def call():
                return tail_ops.fused_decode_layer_tail(
                    x, kv[0], kv[1], masks[0], kv[2], kv[3], masks[1], pad, weights,
                    fold=beam, n_heads=heads)

            first = None
            for name, lib in libs:
                key = f"decode_tail {dn} b{batch}: {name}"
                _cuda._lib = _TailLib(lib)
                try:
                    with torch.no_grad():
                        out = call().float()
                        first = out if first is None else first
                        close[key] = ((out - first).abs().max() / first.abs().max()).item()
                        if not close[key] <= (2e-5 if dtype == torch.float32 else 3e-2):
                            raise RuntimeError(f"{key}: {close[key]:.3e} of the first's max apart")
                        totals[key] = graph_ms(call)
                except RuntimeError as exc:   # a variant the card refuses is reported, not timed
                    print(f"{key}: failed: {exc}", flush=True)
                    torch.cuda.synchronize()
                finally:
                    _cuda._lib = saved


def msda_variants(built: list, totals: dict, close: dict) -> None:
    """K3's and K6's variants at a b16 XE step's and a b128 caption batch's
    MSDA (384x640 pyramid, 150 queries, 8 heads of 64 channels, 4 x 4 taps,
    half the images padded), both types, each launch alone through the C
    entry (K6 without the wrapper's zero-fill and casts); each variant's
    outputs checked within 2e-5 (fp32) / 3e-2 (bf16) of the first's max,
    but for the part a variant cuts out."""
    import chip_smoke
    from grit_tpu_torch.ops import msda as msda_ops

    libs = [(name, lib) for src, name, lib in built if src == "msda.cu"]
    if not libs:
        return
    g = torch.Generator(device="cuda").manual_seed(4)
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        tol = 2e-5 if dtype == torch.float32 else 3e-2
        for batch in (16, 128):
            args = chip_smoke.msda_inputs(g, batch, chip_smoke.MSDA_LEVELS, dtype)
            loc, attn, rh, shapes = msda_ops._check("msda", *args)
            value = args[0]
            n, s, c = value.shape
            _, lq, m, L, p, _ = loc.shape
            dims = (n, s, lq, m, c // m, L, p, _cuda.DTYPE_CODE[dtype])
            dout = torch.randn(n, lq, c, generator=g, device="cuda").to(dtype)
            out = torch.empty(n, lq, c, device="cuda", dtype=dtype)
            dvalue = torch.empty(n, s, c, device="cuda")
            dloc, dattn = torch.empty_like(loc), torch.empty_like(attn)
            first: dict[str, torch.Tensor] = {}
            for name, lib in libs:

                def fwd(lib=lib):
                    _cuda.check(lib.grit_msda(value.data_ptr(), shapes.data_ptr(),
                                              loc.data_ptr(), attn.data_ptr(), rh.data_ptr(),
                                              out.data_ptr(), *dims, stream()), name)

                def bwd(lib=lib):
                    _cuda.check(lib.grit_msda_bwd(
                        value.data_ptr(), shapes.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                        rh.data_ptr(), dout.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                        dattn.data_ptr(), *dims, stream()), name)

                try:
                    fwd()
                    dvalue.zero_()
                    bwd()
                    got = {"K3 out": out.float(), "K6 dvalue": dvalue.clone(),
                           "K6 dloc": dloc.clone(), "K6 dattn": dattn.clone()}
                    for part, t in got.items():
                        if "scatter" in name and part == "K6 dvalue":
                            continue
                        ref = first.setdefault(part, t)
                        rel = ((t - ref).abs().max() / ref.abs().max()).item()
                        key = f"{part[:2]} {dn} b{batch}: {name}"
                        close[key] = max(close.get(key, 0.0), rel)
                        if not rel <= tol:
                            raise RuntimeError(f"{key} {part}: {rel:.3e} of the first's max apart")
                    totals[f"K3 {dn} b{batch}: {name}"] = graph_ms(fwd)
                    totals[f"K6 {dn} b{batch}: {name}"] = graph_ms(bwd)
                except RuntimeError as exc:   # a variant the card refuses is reported
                    print(f"msda {dn} b{batch} {name}: failed: {exc}", flush=True)
                    torch.cuda.synchronize()


def lsa_variants(built: list, totals: dict, close: dict) -> None:
    """grit_lsa's variants through the C entry at a b4 detector step's
    problems, continuous and integer costs; "as is" checked equal to the
    plain version's assignments (``close``: the count that differ)."""
    import chip_smoke
    from grit_tpu_torch.ops import lsa as lsa_ops

    libs = [(name, lib) for src, name, lib in built if src == "lsa.cu"]
    if not libs:
        return
    p, q, g = (chip_smoke.DET_LAYERS + 1) * chip_smoke.DET_BATCH, 150, chip_smoke.MAX_BOXES
    fills = [chip_smoke.LSA_FILLS[i % len(chip_smoke.LSA_FILLS)] for i in range(p)]
    n_valid = torch.tensor(fills, device="cuda")
    rng = np.random.default_rng(6000)
    for kind in ("continuous", "integer"):
        c = (rng.standard_normal((p, q, g)) * 3 if kind == "continuous"
             else rng.integers(0, 5, (p, q, g)))
        cost = torch.from_numpy(c.astype(np.float32)).cuda()
        want = lsa_ops.lsa_plain(cost.cpu(), n_valid.cpu())
        assign = torch.empty(p, g, dtype=torch.int64, device="cuda")
        for name, lib in libs:

            def call(lib=lib):
                _cuda.check(lib.grit_lsa(cost.data_ptr(), n_valid.data_ptr(), assign.data_ptr(),
                                         p, q, g, stream()), name)

            key = f"grit_lsa {kind} [{p}, {q}, {g}]: {name}"
            try:
                call()
                torch.cuda.synchronize()
                if name not in LSA_CUT:
                    close[key] = int((assign.cpu() != want).sum())
                    if close[key]:
                        raise RuntimeError(f"{close[key]} assignments differ from the plain version")
                totals[key] = graph_ms(call)
            except RuntimeError as exc:   # a variant the card refuses is reported
                print(f"{key}: failed: {exc}", flush=True)
                torch.cuda.synchronize()


def ln_variants(built: list, totals: dict, close: dict, parent_bits: dict) -> None:
    """The LayerNorm group: each variant of ln_rows_kernel and
    ln_merge_kernel through the C entries at each shape of
    chip_smoke.phase_ln_kernels, by graph replay beside F.layer_norm, its
    outputs checked within chip_smoke.TOL of the plain version's
    (``close``) and, with --parent, compared bit for bit with the parent's
    (``parent_bits``); ``totals`` also holds each run's sums over its
    launches."""
    import chip_smoke

    libs = [(name, lib) for src, name, lib in built if is_ln(src, name)]
    if not libs:
        return
    g = torch.Generator(device="cuda").manual_seed(7)
    for run, dt, batch, stages, hw in chip_smoke.LN_RUNS:
        dn = "bf16" if dt == torch.bfloat16 else "fp32"
        tol = chip_smoke.TOL[dt]
        for case in chip_smoke.ln_cases(run, batch, stages, hw):
            label, kind, calls = case[:3]
            kernel = "ln_merge_kernel" if kind == "merge" else "ln_rows_kernel"
            t = chip_smoke.ln_case_inputs(case, dt, g)
            ref = t["plain"]().float()
            checked, outs = {"F.layer_norm": t["library"]}, {}
            for name, lib in libs:
                key = f"ln {run} {dn} {label}: {name}"
                try:
                    call = t["launch"](lib)
                    t["out"].fill_(float("nan"))
                    call()
                    close[key] = ((t["out"].float() - ref).abs().max() / ref.abs().max()).item()
                    if not close[key] <= tol:
                        raise RuntimeError(f"{close[key]:.3e} of the plain version's max apart")
                    checked[name], outs[name] = call, t["out"].clone()
                except RuntimeError as exc:   # a variant the card refuses is reported
                    print(f"{key}: failed: {exc}", flush=True)
                    torch.cuda.synchronize()
            if "parent" in outs:   # whether each variant's outputs are the parent's bits
                for name, o in outs.items():
                    parent_bits[f"ln {run} {dn} {label}: {name}"] = torch.equal(o, outs["parent"])
            # three rounds, each timing every variant in turn: the median of each
            times = {name: [] for name in checked}
            for _ in range(3):
                for name, call in checked.items():
                    times[name].append(graph_ms(call))
            for name, ms in times.items():
                totals[f"ln {run} {dn} {label}: {name}"] = statistics.median(ms)
                total = f"{kernel} {run} {dn}, summed over the run: {name}"
                totals[total] = totals.get(total, 0.0) + calls * statistics.median(ms)
            del t, ref, checked, outs


def main() -> None:
    if not torch.cuda.is_available():
        print("kernel_variants: FAIL: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    built = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    totals: dict[str, float] = {}
    for c, heads, (hp, wp), depth in STAGES:
        if not any(src in ("gemm_sm90.cu", "window_attn_mma.cu") for src, _, _ in built):
            break
        rows = BATCH * hp * wp
        a = torch.randn(rows, c, generator=g, device="cuda").to(bf)
        h4 = torch.randn(rows, 4 * c, generator=g, device="cuda").to(bf)
        for x, (n, k) in ((a, (3 * c, c)), (a, (c, c)), (a, (4 * c, c)), (h4, (c, 4 * c))):
            w = (torch.randn(n, k, generator=g, device="cuda") * k ** -0.5).to(bf)
            bias = torch.randn(n, generator=g, device="cuda").to(bf)
            out = torch.empty(rows, n, device="cuda", dtype=bf)
            for src, name, lib in built:
                if src != "gemm_sm90.cu":
                    continue

                def call(lib=lib):
                    err = lib.variant_entry(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                            out.data_ptr(), rows, n, k, stream())
                    if err:
                        raise RuntimeError(f"gemm variant {name}: CUDA error {err}")

                key = f"gemm_bf16: {name}"
                totals[key] = totals.get(key, 0.0) + graph_ms(call) * depth
            key = "gemm_bf16: F.linear"
            totals[key] = totals.get(key, 0.0) + graph_ms(lambda: F.linear(x, w, bias)) * depth
        qkv = torch.randn(rows, 3 * c, generator=g, device="cuda").to(bf)
        table = torch.randn((2 * WINDOW - 1) ** 2, heads, generator=g, device="cuda")
        out = torch.empty(rows, c, device="cuda", dtype=bf)
        for src, name, lib in built:
            if src != "window_attn_mma.cu":
                continue

            def call(lib=lib):
                err = lib.variant_entry(qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
                                        rows // (WINDOW * WINDOW), c, heads, hp, wp, WINDOW,
                                        WINDOW // 2, stream())
                if err:
                    raise RuntimeError(f"core variant {name}: CUDA error {err}")

            key = f"win_attn: {name}"
            totals[key] = totals.get(key, 0.0) + graph_ms(call) * depth
        q, kk, v = (torch.randn(rows // WINDOW ** 2, heads, WINDOW ** 2, 32, generator=g,
                                device="cuda").to(bf) for _ in range(3))
        mask = torch.randn(1, heads, WINDOW ** 2, WINDOW ** 2, generator=g, device="cuda").to(bf)
        key = "win_attn: SDPA + mask"
        totals[key] = totals.get(key, 0.0) + graph_ms(
            lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=mask)) * depth
    f32 = torch.float32
    same: dict[str, bool] = {}   # an fp32 GEMM variant's outputs equal to the first's
    close: dict[str, float] = {}  # an fp32 core variant's largest error against the first's
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c, heads, (hp, wp), depth in DET_STAGES:
        if not any(src == "win_attn_f32.cu" for src, _, _ in built):
            break
        rows = DET_BATCH * hp * wp
        qkv = torch.randn(rows, 3 * c, generator=g, device="cuda")
        qkv[:, :c] *= 32 ** -0.5
        table = torch.randn((2 * WINDOW - 1) ** 2, heads, generator=g, device="cuda")
        out = torch.empty(rows, c, device="cuda", dtype=f32)
        for shift in (0, WINDOW // 2):
            first = None
            for src, name, lib in built:
                if src != "win_attn_f32.cu" or name.startswith("backward"):
                    continue

                def call(lib=lib, shift=shift):
                    err = lib.variant_entry(qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
                                            rows // (WINDOW * WINDOW), c, heads, hp, wp, WINDOW,
                                            shift, stream())
                    if err:
                        raise RuntimeError(f"fp32 core variant {name}: CUDA error {err}")

                out.fill_(float("nan"))
                call()
                if first is None:
                    first = out.clone()
                key = f"win_attn_f32: {name}"
                rel = ((out - first).abs().max() / first.abs().max()).item()
                close[key] = max(close.get(key, 0.0), rel)
                if not rel <= 2e-5:
                    raise RuntimeError(f"{key}: {rel:.3e} of the first variant's max apart")
                totals[key] = totals.get(key, 0.0) + graph_ms(call) * (depth // 2)
        q, kk, v = (torch.randn(rows // WINDOW ** 2, heads, WINDOW ** 2, 32, generator=g,
                                device="cuda") for _ in range(3))
        mask = torch.randn(1, heads, WINDOW ** 2, WINDOW ** 2, generator=g, device="cuda")
        key = "win_attn_f32: SDPA + mask fp32"
        totals[key] = totals.get(key, 0.0) + graph_ms(
            lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=mask)) * depth
        # the fp32 backward (K5's launch) on the same qkv, its batch split as the wrapper's
        nw = (hp // WINDOW) * (wp // WINDOW)
        chunks = bwd_batch_chunks(DET_BATCH, nw * heads, sms)
        d_ao = torch.randn(rows, c, generator=g, device="cuda")
        dqkv = torch.empty(rows, 3 * c, device="cuda", dtype=f32)
        dbias = torch.empty(chunks, nw, heads, WINDOW ** 4, device="cuda", dtype=f32)
        for shift in (0, WINDOW // 2):
            for src, name, lib in built:
                if src != "win_attn_f32.cu" or not (name == "as is" or name.startswith("backward")):
                    continue

                def call(lib=lib, shift=shift):
                    err = lib.variant_bwd_entry(qkv.data_ptr(), d_ao.data_ptr(), table.data_ptr(),
                                                dqkv.data_ptr(), dbias.data_ptr(), DET_BATCH,
                                                chunks, c, heads, hp, wp, WINDOW, shift, stream())
                    if err:
                        raise RuntimeError(f"fp32 backward variant {name}: CUDA error {err}")

                key = f"win_attn_bwd_f32: {name.replace('backward: ', '')}"
                totals[key] = totals.get(key, 0.0) + graph_ms(call) * (depth // 2)
    for c, heads, (hp, wp), depth in DET_STAGES:
        if not any(src == "swin_block.cu" and not name.startswith("ln:")
                   for src, name, _ in built) or SELECTED == {"ln"}:
            break
        rows = DET_BATCH * hp * wp
        a = torch.randn(rows, c, generator=g, device="cuda")
        h4 = torch.randn(rows, 4 * c, generator=g, device="cuda")
        for x, (n, k) in ((a, (3 * c, c)), (a, (c, c)), (a, (4 * c, c)), (h4, (c, 4 * c))):
            w = torch.randn(n, k, generator=g, device="cuda") * k ** -0.5
            bias = torch.randn(n, generator=g, device="cuda")
            out = torch.empty(rows, n, device="cuda", dtype=f32)
            first = None
            for src, name, lib in built:
                if src != "swin_block.cu" or name.startswith("ln:"):
                    continue

                def call(lib=lib):
                    err = lib.variant_entry(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                            out.data_ptr(), rows, n, k, stream())
                    if err:
                        raise RuntimeError(f"fp32 gemm variant {name}: CUDA error {err}")

                # every variant keeps each output's fmaf chain: the same bits as the first
                out.fill_(float("nan"))
                call()
                if first is None:
                    first = out.clone()
                key = f"gemm_f32: {name}"
                same[key] = same.get(key, True) and torch.equal(out, first)
                totals[key] = totals.get(key, 0.0) + graph_ms(call) * depth
            key = "gemm_f32: F.linear"
            totals[key] = totals.get(key, 0.0) + graph_ms(lambda: F.linear(x, w, bias)) * depth
    decode_tail_variants(built, totals, close)
    msda_variants(built, totals, close)
    lsa_variants(built, totals, close)
    parent_bits: dict[str, bool] = {}   # an LN variant's outputs equal to the parent's
    ln_variants(built, totals, close, parent_bits)
    for key, ms in totals.items():
        per = (f"b{DET_BATCH} 832x1344 detector step"
               if key.startswith(("gemm_f32", "win_attn_f32", "win_attn_bwd_f32"))
               else "call" if key.startswith(("decode_tail", "K3", "K6", "grit_lsa", "ln "))
               else "run" if key.startswith(("ln_rows_kernel", "ln_merge_kernel"))
               else f"b{BATCH} forward")
        bits = f", bit-equal to the first: {same[key]}" if key in same else ""
        if key in close:
            bits = (f", {close[key]} assignments differ from the plain version's"
                    if key.startswith("grit_lsa") else
                    f", {close[key]:.2e} of the plain version's max from it" if key.startswith("ln ")
                    else f", {close[key]:.2e} of the first's max from it")
        if key in parent_bits:
            bits += f", the parent's bits: {parent_bits[key]}"
        print(f"{key:<45} {ms:.4f} ms a {per}{bits}  [{card}]")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"kernel_variants{SUFFIX}.json"), "w") as f:
        json.dump({"card": card, "csrc": str(CSRC), "ms_per_run": totals, "bit_equal_to_first": same,
                   "max_rel_to_first": close, "ln_parent_bits": parent_bits}, f, indent=1)


if __name__ == "__main__":
    main()
