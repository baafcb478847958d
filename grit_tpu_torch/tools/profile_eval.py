"""Phase split of one beam-5 caption batch of the port: the Swin backbone /
the detection stack / the grid net / the visual-KV precompute / the 20 decode
steps, beside the full ``generate`` (the counterpart of the JAX package's
tools/profile_eval.py).

  python -m grit_tpu_torch.tools.profile_eval [batch] [--trace DIR]
      [--device cuda|cpu] [overrides...]

The model is the caption config's at full width on seed-0 random weights, in
bf16, in eval(); the batch is ``batch``
(default 128) unpadded uint8 images of ``dataset.transform_cfg.size``
(384x640) from a seed.  Each phase runs alone on the inputs the phase before
made, timed by CUDA events (the median of REPS calls after a warm-up),
so the numbers attribute the batch's time (where effort would pay), and need
not add up to the full call: the full ``generate`` row is
``engine.evaluator.make_caption_generator``'s, the evaluation loop's own
call.  ``--trace DIR`` writes a torch.profiler chrome trace of one more full
batch (``python -m grit_tpu_torch.tools.agg_trace DIR`` sums it).  Without a
card the tool raises unless ``--device cpu`` or ``exp.device=cpu`` is given
(then the host's clock times it).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

BEAM, MAX_LEN = 5, 20
REPS = 5


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m grit_tpu_torch.tools.profile_eval")
    ap.add_argument("batch", nargs="?", type=int, default=128)
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler chrome trace of the full batch to this directory")
    return ap.parse_known_args(argv)


@torch.inference_mode()
def main(argv=None) -> dict:
    from grit_tpu_torch.decoding.beam_search import beam_search
    from grit_tpu_torch.engine.evaluator import make_caption_generator
    from grit_tpu_torch.eval_caption import caption_config, config_device
    from grit_tpu_torch.models.captioner import build_captioner
    from grit_tpu_torch.tools.timing import device_line, event_ms, sync
    from grit_tpu_torch.utils.misc import start_profiler_trace, stop_profiler_trace
    from grit_tpu_torch.utils.nested import ImageBatch, device_normalize

    args, overrides = parse(sys.argv[1:] if argv is None else argv)
    config = caption_config(overrides)
    device = config_device(config, "profile_eval")
    m = config.model
    b = args.batch
    h, w = config.dataset.transform_cfg.size
    model = build_captioner(config, device=device, dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(0)
    images = ImageBatch(torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)),
                        torch.zeros((b, h, w), dtype=torch.bool)).to(device)
    print(f"profile_eval: b{b} {h}x{w} bf16, beam {BEAM} x {MAX_LEN} steps, on "
          f"{device_line(device)}", flush=True)

    def decode(vis, kv):
        def decode_fn(token, t, vis_in, cache):
            return model.decode_step(token, t, vis_in["feat"], cache, vis_kv=vis_in["kv"],
                                     vis_fold=BEAM)

        cache = model.init_cache(b * BEAM, MAX_LEN)
        return beam_search(decode_fn, cache, {"feat": vis, "kv": kv}, b, BEAM, MAX_LEN,
                           m.bos_idx, m.eos_idx, out_size=1).sequences

    generate = make_caption_generator(model, beam_size=BEAM, max_len=MAX_LEN, bos_idx=m.bos_idx,
                                      eos_idx=m.eos_idx)
    # each phase's inputs, made once by the phase before
    vis = model.compute_vis(images)
    kv = model.precompute_vis_kv(vis)
    sync(device)
    phases = {
        "backbone (Swin)": lambda: model.detector.backbone(device_normalize(images).images),
        "detector (Swin+projs+det)": lambda: model.detector(images),
        "compute_vis (det+grid_net)": lambda: model.compute_vis(images),
        "precompute_vis_kv": lambda: model.precompute_vis_kv(vis),
        f"decode ({MAX_LEN} steps)": lambda: decode(vis, kv),
        "FULL generate": lambda: generate(images, b),
    }
    ms = {}
    for name, fn in phases.items():
        fn()                                   # warm-up (and the kernels' build)
        sync(device)
        ms[name] = event_ms(fn, device, REPS)
        print(f"{name:28s} {ms[name]:9.1f} ms/call  (median of {REPS})", flush=True)
    t_bb, t_det, t_vis, t_kv, t_dec, t_full = ms.values()
    split = {"Swin backbone": t_bb, "det stack": t_det - t_bb, "grid net": t_vis - t_det,
             "vis-KV precompute": t_kv, f"decode ({MAX_LEN} steps)": t_dec}
    print(f"\nattribution at batch {b} (ms):")
    for name, t in split.items():
        print(f"  {name:20s} {t:8.1f}")
    print(f"  {'sum of phases':20s} {t_vis + t_kv + t_dec:8.1f}")
    print(f"  {'full generate':20s} {t_full:8.1f}")
    print(f"  -> {b / t_full * 1e3:.1f} img/s", flush=True)
    out = {"batch": b, "device": device_line(device), "phases_ms": ms, "split_ms": split,
           "images_per_s": b / t_full * 1e3}
    if args.trace:
        prof = start_profiler_trace(args.trace, device.type)
        generate(images, b)
        sync(device)
        out["trace"] = stop_profiler_trace(prof, f"generate_b{b}")
        print(f"trace written to {out['trace']}", flush=True)
    return out


if __name__ == "__main__":
    main()
