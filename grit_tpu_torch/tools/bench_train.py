"""Training-step benchmark of the port: XE steps, SCST iterations and detector
steps at the configs' full sizes, on random weights (the counterpart of the
JAX package's tools/bench_train.py).

  python -m grit_tpu_torch.tools.bench_train --phase xe --batches 16,32,64 --iters 8
  python -m grit_tpu_torch.tools.bench_train --phase both    # XE, then SCST
  python -m grit_tpu_torch.tools.bench_train --phase det --det-batches 4 --det-size 832,1344

Each step is the port's own (``engine.xe.make_xe_train_step``; the SCST
iteration's ``engine.scst.make_generate_step`` then
``make_scst_update_step`` on random rewards; ``detection.solver.
make_detector_train_step``), in bf16 over f32 master parameters, as the
JAX tool runs them.  After a warm-up step (its time printed apart:
it builds the kernels on a fresh checkout), ``--iters`` steps are each waited
for with ``torch.cuda.synchronize()``: the median ms/step, images/s and the
peak device memory are printed per batch size, then the same steps issued
back to back and waited for once ("chained", the loops' pattern).  The XE
step runs with ``frozen_stages=2`` as the fine-tuning recipe does
(``--frozen-stages -1``: the whole backbone trains).  ``--trace DIR`` writes a
torch.profiler chrome trace of one more step per batch size
(``python -m grit_tpu_torch.tools.agg_trace DIR`` sums it).  Dotted overrides
apply to the caption config and, for ``det``, to the detection config;
``--device cpu`` or ``exp.device=cpu`` runs on the CPU (host clock), and
without either and without a card the tool raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

SCHED = dict(num_epochs=10, num_its_per_epoch=1000, init_lr=1e-4, min_lr=1e-4,
             warmup_init_lr=1e-5)


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m grit_tpu_torch.tools.bench_train")
    ap.add_argument("--phase", choices=("xe", "sc", "det", "both"), default="xe")
    ap.add_argument("--batches", default="16,32,64")
    ap.add_argument("--sc-batches", default="4,8")
    ap.add_argument("--det-batches", default="4")
    ap.add_argument("--det-size", default="832,1216",
                    help="detector images H,W (the reference's ~800/1333 bucket)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=20)
    ap.add_argument("--frozen-stages", type=int, default=2)
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler chrome trace of one step to this directory")
    return ap.parse_known_args(argv)


def images(rng, b: int, h: int, w: int, device):
    from grit_tpu_torch.utils.nested import ImageBatch

    return ImageBatch(torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)),
                      torch.zeros((b, h, w), dtype=torch.bool)).to(device)


def run(tag: str, step, batches, args, device) -> list[dict]:
    """Time ``step(b)`` (a callable built for batch size b) at each batch
    size -> one record each."""
    from grit_tpu_torch.tools.timing import chained_ms, fenced_ms, median, sync
    from grit_tpu_torch.utils.misc import (device_memory_mb, start_profiler_trace,
                                           stop_profiler_trace)

    out = []
    for b in batches:
        fn = step(b)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        first = fenced_ms(fn, device, 1)[0]
        times = fenced_ms(fn, device, args.iters)
        ms = median(times)
        peak = device_memory_mb(device) if device.type == "cuda" else None
        ips = b / ms * 1e3
        print(f"[{tag} b={b}] first step {first / 1e3:.1f} s  median step {ms:.1f} ms  "
              f"{ips:.1f} img/s  peak " + (f"{peak:.0f} MB" if peak is not None else
                                          "not measured (cpu)")
              + f"  (iters: {[round(t, 1) for t in times]})", flush=True)
        k = max(args.iters, 2)
        sus = chained_ms(fn, device, k)
        print(f"[{tag} b={b}] chained x{k}: {sus:.1f} ms/step  {b / sus * 1e3:.1f} img/s",
              flush=True)
        rec = {"phase": tag, "batch": b, "first_s": first / 1e3, "ms": ms, "iters_ms": times,
               "images_per_s": ips, "chained_ms": sus, "peak_mb": peak}
        if args.trace:
            prof = start_profiler_trace(args.trace, device.type)
            fn()
            sync(device)
            rec["trace"] = stop_profiler_trace(prof, f"{tag}_b{b}")
            print(f"[{tag} b={b}] trace written to {rec['trace']}", flush=True)
        out.append(rec)
    return out


def main(argv=None) -> list[dict]:
    from grit_tpu_torch.config import default_detection_config
    from grit_tpu_torch.engine import optim as optim_lib
    from grit_tpu_torch.engine import xe as xe_lib
    from grit_tpu_torch.eval_caption import caption_config, config_device
    from grit_tpu_torch.models.captioner import build_captioner
    from grit_tpu_torch.tools.timing import device_line

    args, overrides = parse(sys.argv[1:] if argv is None else argv)
    if "--device" in overrides:   # as caption_config reads it, for both configs
        i = overrides.index("--device")
        overrides[i:i + 2] = [f"exp.device={overrides[i + 1]}"]
    config = caption_config(overrides)
    device = config_device(config, "bench_train")
    dtype = torch.bfloat16
    print(f"bench_train on {device_line(device)}, bf16 over f32 master parameters", flush=True)
    rng = np.random.default_rng(0)
    records = []
    m = config.model
    h, w = config.dataset.transform_cfg.size

    if args.phase in ("xe", "sc", "both"):
        config.model.frozen_stages = args.frozen_stages
        model = build_captioner(config, device=device, dtype=dtype, seed=0, train=True)
        freeze = (optim_lib.frozen_mask(
            model, optim_lib.swin_frozen_stages_predicate(args.frozen_stages))
            if args.frozen_stages >= 0 else None)
        opt = optim_lib.build_optimizer(
            model, model_lr=SCHED["init_lr"], backbone_lr=config.optimizer.xe_backbone_lr,
            beta_1=config.optimizer.beta_1, beta_2=config.optimizer.beta_2, freeze=freeze)
        state = xe_lib.TrainState(model, opt, global_steps=1,
                                  generator=torch.Generator(device=device).manual_seed(0))

    if args.phase in ("xe", "both"):
        xe_step = xe_lib.make_xe_train_step(pad_idx=m.pad_idx, sched_cfg=SCHED,
                                            backbone_lr=config.optimizer.xe_backbone_lr)

        def xe(b):
            caps = np.concatenate([np.full((b, 1), m.bos_idx),
                                   rng.integers(4, m.vocab_size, (b, args.seq_len - 2)),
                                   np.full((b, 1), m.eos_idx)], axis=1)
            batch = {"samples": images(rng, b, h, w, device),
                     "captions": torch.from_numpy(caps).to(device)}
            return lambda: xe_step(state, batch)

        records += run(f"XE fs={args.frozen_stages}", xe, _ints(args.batches), args, device)

    if args.phase in ("sc", "both"):
        from grit_tpu_torch.engine import scst as scst_lib

        beam = m.beam_size
        generate = scst_lib.make_generate_step(model, beam_size=beam, max_len=m.beam_len,
                                               bos_idx=m.bos_idx, eos_idx=m.eos_idx)
        update = scst_lib.make_scst_update_step(bos_idx=m.bos_idx, eos_idx=m.eos_idx,
                                                model_lr=5e-6, backbone_lr=5e-6)

        def sc(b):
            samples = images(rng, b, h, w, device)
            rewards = rng.random((b, beam)).astype(np.float32)

            def iteration():
                seqs, _ = generate(samples, b, state.generator)
                return update(state, samples, seqs, rewards, b)
            return iteration

        records += run(f"SC beam={beam} fs={args.frozen_stages}", sc, _ints(args.sc_batches),
                       args, device)

    if args.phase == "det":
        from grit_tpu_torch.detection import losses as det_losses
        from grit_tpu_torch.detection import solver
        from grit_tpu_torch.detection.detector import build_detection_model

        dconfig = default_detection_config().apply_overrides(overrides)
        dmodel, crit = build_detection_model(dconfig, dtype, device=device, seed=0)
        o = dconfig.optimizer
        dopt = optim_lib.build_detector_optimizer(
            dmodel, lr=o.lr, lr_backbone=o.lr_backbone, sp_lr=o.sp_lr,
            weight_decay=o.weight_decay, sp_names=list(o.sp_names))
        dstate = xe_lib.TrainState(dmodel, dopt, global_steps=0,
                                   generator=torch.Generator(device=device).manual_seed(0))
        dstep = solver.make_detector_train_step(crit, clip_max_norm=o.clip_max_norm)
        dh, dw = _ints(args.det_size)
        g = int(dconfig.dataset.max_boxes)
        nbox = min(25, g)

        last = {}

        def det(b):
            boxes = np.stack([rng.uniform(.2, .8, (b, g)), rng.uniform(.2, .8, (b, g)),
                              rng.uniform(.02, .2, (b, g)), rng.uniform(.02, .2, (b, g))], -1)
            targets = {
                "labels": torch.from_numpy(
                    rng.integers(0, dconfig.model.detector.num_classes, (b, g))).to(device),
                "boxes": torch.from_numpy(boxes.astype(np.float32)).to(device),
                "valid": torch.from_numpy(np.tile([True] * nbox + [False] * (g - nbox),
                                                  (b, 1))).to(device)}
            samples = images(rng, b, dh, dw, device)

            def step():
                last["metrics"] = dstep(dstate, samples, targets)[1]
            return step

        match = det_losses._resolve_impl(crit.cost["impl"], device)
        for rec in run(f"DET {dh}x{dw} match={match}", det, _ints(args.det_batches), args,
                       device):
            rec["grad_norm"] = float(last["metrics"]["grad_norm"])
            print(f"[DET b={rec['batch']}] grad_norm {rec['grad_norm']:.3e}", flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
