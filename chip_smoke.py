"""GPU smoke test of the PyTorch/CUDA port (grit_tpu_torch) on one card.

  python3 chip_smoke.py              # every phase, b8
  python3 chip_smoke.py --profile    # and a torch.profiler pass over one batch

Phases, each of which must pass:
  1. build the Hopper kernels from grit_tpu_torch/csrc (nvcc, sm_90a);
  2. K1 (Swin attention half-block), K2 (Swin MLP) and K3 (MSDA) against
     their plain PyTorch versions on the card, at every shape the main path
     gives them at 384x640, in fp32 and bf16, with CUDA-event timings;
  3. the main path: batch caption inference at the full width of the
     shipped GRIT model on random weights (seed 0), bf16, beam 5, 20 steps,
     through grit_tpu_torch.engine.evaluator.make_caption_generator, with
     each kernel's launch count checked against one forward's calls;
  4. the same model in fp32, kernel path against plain path: features within
     tolerance, captions token for token (a difference only at a near-tie:
     at the first differing step, the gap between adjacent candidates among
     the top beam+1 must be <= 1e-3); then the bf16 kernel path's features
     against the fp32 plain path's.

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

    from grit_tpu.config import default_caption_config
    from grit_tpu_torch.decoding.beam_search import beam_search
    from grit_tpu_torch.engine.evaluator import make_caption_generator
    from grit_tpu_torch.models.captioner import build_captioner
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
DET_LAYERS = 6
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

RESULTS: dict[str, dict] = {}
DETAIL: list[dict] = []


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
            calls: int) -> None:
    if not torch.isfinite(out).all():
        fail(f"{kernel} {case}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    tol = TOL[dtype]
    print(f"  {kernel} {case:<24} max_abs {err:.3e} max_rel {rel:.3e} (tol {tol:.0e})  "
          f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)
    if rel > tol:
        fail(f"{kernel} {case}: max rel err {rel:.3e} > {tol:.0e}")
    rec = RESULTS.setdefault(kernel, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    DETAIL.append({"kernel": kernel, "case": case, "max_abs_err": err, "max_rel_err": rel,
                   "tol": tol, "ms": ms, "plain_ms": plain_ms, "calls_per_forward": calls})
    if dtype == torch.bfloat16:
        # the main path's time in this kernel per forward: each shape's
        # median time times the calls one forward makes at that shape
        rec["ms"] += ms * calls
        rec["plain_ms"] += plain_ms * calls


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
                        cuda_ms(lambda: wa.block_step_plain(x, **p, **kw)), depth // 2)
            rows = x.reshape(-1, c)
            m = [1 + rnd(c, scale=0.1), rnd(c, scale=0.1),
                 rnd(4 * c, c, scale=c ** -0.5).to(dtype), rnd(4 * c, scale=0.02).to(dtype),
                 rnd(c, 4 * c, scale=(4 * c) ** -0.5).to(dtype), rnd(c, scale=0.02).to(dtype)]
            compare("K2", f"{dn} {name}", wa.mlp(rows, *m), wa.mlp_plain(rows, *m), dtype,
                    cuda_ms(lambda: wa.mlp(rows, *m)), cuda_ms(lambda: wa.mlp_plain(rows, *m)),
                    depth)

        s = sum(h * w for h, w in MSDA_LEVELS)
        lq, mh, d, L, P = 150, 8, 64, len(MSDA_LEVELS), 4
        value = rnd(batch, s, mh * d).to(dtype)
        # locations spill past [0, 1] so zero padding is exercised
        loc = torch.rand(batch, lq, mh, L, P, 2, generator=g, device=DEV) * 1.2 - 0.1
        attn = torch.softmax(rnd(batch, lq, mh, L * P), -1).reshape(batch, lq, mh, L, P)
        real_hw = torch.tensor(MSDA_LEVELS, device=DEV).repeat(batch, 1, 1)
        real_hw[1::2] = (real_hw[1::2] * 3 + 3) // 4   # half the images padded
        args = (value, MSDA_LEVELS, loc, attn, real_hw)
        compare("K3", f"{dn} 384x640 pyramid", msda_ops.msda(*args),
                msda_ops.msda_plain(*args), dtype, cuda_ms(lambda: msda_ops.msda(*args)),
                cuda_ms(lambda: msda_ops.msda_plain(*args)), DET_LAYERS)


def synthetic_batch(batch: int) -> ImageBatch:
    """uint8 images from a seed; every other image smaller than the bucket."""
    rng = np.random.default_rng(0)
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


def phase_profile(batch: int, card: str) -> None:
    """torch.profiler over one bf16 caption batch: device busy time and the
    kernels that take it, written to chiprun_out/profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    config = default_caption_config()
    model = build_captioner(config, device=DEV, dtype=torch.bfloat16, seed=0)
    samples = synthetic_batch(batch)
    gen = make_caption_generator(model, beam_size=BEAM, max_len=STEPS,
                                 bos_idx=config.model.bos_idx,
                                 eos_idx=config.model.vocab_size)
    gen(samples, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen(samples, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    lines = [f"b{batch} bf16 caption batch [{card}]: wall {wall * 1e3:.1f} ms, device busy "
             f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.3f}, "
             f"{sum(r[1] for r in rows)} kernel launches"]
    lines += [f"{us / 1e3:10.3f} ms {n:6d}x  {name[:110]}" for us, n, name in rows[:40]]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("[profile] " + "\n[profile] ".join(lines[:16]), flush=True)


@contextlib.contextmanager
def plain_arm():
    """Swap the three kernel wrappers for their plain versions (comparison only)."""
    saved = wa.block_step, wa.mlp, msda_ops.msda
    wa.block_step, wa.mlp, msda_ops.msda = wa.block_step_plain, wa.mlp_plain, msda_ops.msda_plain
    try:
        yield
    finally:
        wa.block_step, wa.mlp, msda_ops.msda = saved


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one bf16 caption batch")
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
    print(f"[build] kernel library ready in {time.perf_counter() - t0:.1f} s", flush=True)

    phase_kernels(args.batch)
    phase_slice(args.batch, card)
    if args.profile:
        phase_profile(args.batch, card)
    phase_parity(args.batch)

    sources = {"K1": ("grit_tpu_torch/csrc/swin_block.cu",
                      "grit_tpu/ops/window_attention.py:1029"),
               "K2": ("grit_tpu_torch/csrc/swin_block.cu",
                      "grit_tpu/ops/window_attention.py:1819"),
               "K3": ("grit_tpu_torch/csrc/msda.cu", "grit_tpu/ops/msda_pallas.py:1018")}
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": RESULTS[k]["launches"],
                "max_abs_err": RESULTS[k]["max_abs_err"],
                "ms": RESULTS[k]["ms"], "plain_ms": RESULTS[k]["plain_ms"]}
               for k, (src, rep) in sources.items()]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "kernels": kernels,
                   "cases": DETAIL, "slice": RESULTS.get("slice")}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
