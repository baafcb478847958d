"""Driver ``caption_generate_lm``: caption batches of a captioner whose
decoder is a latent-attention, mixture-of-experts language model
(``model.cap_generator.decoder_name="mla_moe"``), through the port's
``engine.evaluator.make_caption_generator``, in the closed loop of
``caption_generate`` (batch i+1 is issued before batch i's tokens are read).

The configuration file holds the language model's published keys at its
top level (``lm_config``); they reach the port as ``model.language_model.*``
overrides.  Set-up builds the captioner on the card with its products'
weights in the configuration's type and no other copy (the language model
is laid out on the meta device first), loads the seed's weights one
parameter at a time (``gritbench/lm_weights.py``), makes the image pool and
runs the warm-up batches.

The check: for a sample drawn from the seed of two finished batches, the
program's projected visual tokens are compared with the float32 reference's
from the images (``reference/vision.py``, ``reference/kimi_lm.py::
project``), and its last layer's prefix latents and the word log-probs
along the beam it chose with the float32 language model
(``gritbench/reference/kimi_lm.py``) over the program's visual tokens, and
the share of routed rows whose experts the program chose otherwise than the
reference; the reference draws the language model's weights a layer at a
time once the program is freed.  ``control`` runs the program with its
routed experts' weights rounded to float8 e4m3 (one scale an expert matrix),
``fault`` with five experts a token in place of six, ``fault_unbiased``
with six chosen without the correction bias; each is judged as the program
is.

A traced run also records the grouped GEMMs' calls (``ops.moe.LAUNCHES``,
read around the window and the profiled stretch) and the rows each MoE call
routed to each expert in the stretch, for ``moe_roofline.caption`` and
``expert_load_max.caption``; decode steps are counted here (the GRIT path's
``decode_tail`` counter counts a kernel this path does not launch).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from gritbench import harness, lm_weights, program
from gritbench.counts import caption as caption_counts, kimi_lm as counts
from gritbench.reference import kimi_lm as ref_lm, vision as ref_vision
from gritbench.reference.nn import Arith, fp32_context, restore
from gritbench.traffic.caption_generate import CaptionRun, caption_lengths, image_pool, percentile
from grit_tpu_torch.config import KIMI_VL_A3B
from grit_tpu_torch.models.lm_decoder import Router
from grit_tpu_torch.ops import moe as moe_ops

FP8_MAX = 448.0


def lm_config(cfg: dict) -> dict:
    """The language model's keys (those of the port's ``KIMI_VL_A3B``) that
    the configuration file sets at its top level."""
    return {k: cfg[k] for k in KIMI_VL_A3B if k in cfg}


def port_config(cfg: dict):
    """The port's caption config: the file's ``port_overrides``, then the
    language model's keys."""
    config = program.caption_config(cfg)
    for k, v in lm_config(cfg).items():
        config.set(f"model.language_model.{k}", v)
    return config


@torch.no_grad()
def round_experts_fp8(model) -> None:
    """The control's weights: each routed expert's matrices rounded to
    float8 e4m3 under a scale of its own (its absolute maximum onto 448)."""
    for name, p in model.named_parameters():
        if name.endswith((".mlp.w13", ".mlp.w2")):
            w = p.float()
            scale = w.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30) / FP8_MAX
            p.copy_((w / scale).to(torch.float8_e4m3fn).float() * scale)


class LMCaptionRun(CaptionRun):
    """``CaptionRun`` with the language-model captioner, its weights, and
    what its check reads."""

    def build(self, seed: int, variant: str | None = None) -> None:
        from grit_tpu_torch.engine import evaluator
        from grit_tpu_torch.models.captioner import build_captioner

        m = self.cfg["model"]
        model = build_captioner(port_config(self.cfg), device=self.device,
                                dtype=program.DTYPES[self.cfg["dtype"]], seed=None)
        self.shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        lm_weights.load(model, self.shapes, seed, self.device, det=m["detector"])
        if variant == "fp8_experts":
            round_experts_fp8(model)
        elif variant == "top5":
            for mod in model.modules():
                if isinstance(mod, Router):
                    mod.top_k = 5
        elif variant == "unbiased":
            with torch.no_grad():
                for mod in model.modules():
                    if isinstance(mod, Router):
                        mod.e_score_correction_bias.zero_()
        self.model = model.eval()
        self._instrument(evaluator)
        self.generate = evaluator.make_caption_generator(
            self.model, beam_size=self.traffic["beam_size"], max_len=self.traffic["beam_len"],
            bos_idx=m["bos_idx"], eos_idx=m["eos_idx"])
        self.pool = image_pool(self.traffic, seed, self.device)

    def _instrument(self, evaluator) -> None:
        """Beyond ``CaptionRun``'s: keep each batch's projected tokens, last
        prefix latents, every router call's choices, and for each decode
        step the rows' input words and parent rows (a ``lineage`` leaf in
        the cache, which the beam search reorders with the rest); count the
        decode steps."""
        super()._instrument(evaluator)
        model = self.model
        self.steps = 0
        prefill, decode, init_cache = model.precompute_vis_kv, model.decode_step, model.init_cache

        def proj_hook(_mod, _inp, out):
            self.cur["vis_tokens"], self.cur["prefix_mask"] = out

        def route_hook(_mod, _inp, out):
            self.cur.setdefault("routes", []).append(out[0])

        def precompute_vis_kv(vis):
            out = prefill(vis)
            self.cur["latent"] = out["latents"][-1]
            return out

        def with_lineage(batch, t_max):
            cache = init_cache(batch, t_max)
            cache["lineage"] = torch.arange(batch, device=self.device)
            return cache

        def decode_step(token, t, vis, cache, **k):
            if t > 0:
                self.steps += 1
                self.cur.setdefault("decode", []).append((token[:, 0], cache["lineage"]))
            cache["lineage"] = torch.arange(token.shape[0], device=token.device)
            return decode(token, t, vis, cache, **k)

        model.projector.register_forward_hook(proj_hook)
        for mod in model.modules():
            if isinstance(mod, Router):
                mod.register_forward_hook(route_hook)
        model.precompute_vis_kv = precompute_vis_kv
        model.init_cache = with_lineage
        model.decode_step = decode_step

    def stretch(self) -> dict:
        moe_ops.take_expert_load()
        before = dict(moe_ops.LAUNCHES)
        rec = super().stretch()
        loads = moe_ops.take_expert_load()
        rec["moe"] = {"launches": {k: moe_ops.LAUNCHES[k] - before[k] for k in before},
                      "loads": [t.tolist() for t in loads]}
        return rec

    def sample(self, seed: int) -> dict:
        """The program's outputs for the sampled images of the kept batches,
        on the host: the longest caption of each batch and others drawn from
        the seed."""
        rng = np.random.default_rng(int(seed) + 1)
        eos = self.cfg["model"]["eos_idx"]
        per = self.traffic["sample_images"]
        names = ("vis_tokens", "latent", "prefix_mask", "tokens", "log_probs", "images", "pad",
                 "route_prefix", "route_words")
        out = {name: [] for name in names}
        seen = set()
        for slot in ("early", "last"):
            k = self.kept[slot]
            if k["index"] in seen:
                continue
            seen.add(k["index"])
            length = caption_lengths(k["beam"].sequences[:, 0].cpu(), eos)
            pick = [int(length.argmax())]
            pick += [int(i) for i in rng.permutation(length.shape[0]) if i != pick[0]][:per - 1]
            idx = torch.tensor(pick, device=k["latent"].device)
            n_vis = k["vis_tokens"].shape[1]
            out["vis_tokens"].append(k["vis_tokens"][idx].float().cpu())
            out["latent"].append(k["latent"][idx, :n_vis].float().cpu())
            out["prefix_mask"].append(k["prefix_mask"][idx].cpu())
            out["tokens"].append(k["beam"].sequences[idx, 0].cpu())
            out["log_probs"].append(k["beam"].log_probs[idx, 0].float().cpu())
            batch = self.pool[k["index"] % len(self.pool)]
            out["images"].append(batch.images[idx.cpu()])
            out["pad"].append(batch.mask[idx.cpu()])
            pre, words = served_routes(k, pick, self.traffic["beam_size"], n_vis)
            out["route_prefix"].append(pre)
            out["route_words"].append(words)
        return {name: torch.cat(v) for name, v in out.items()}

    def free(self) -> None:
        """As ``CaptionRun.free``, then the collector: the wrapped methods
        hold the model in a cycle, which would keep its weights on the card
        while the reference runs."""
        super().free()
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def served_routes(kept: dict, pick: list[int], beam: int, n_vis: int):
    """The program's expert choices along each picked image's served
    caption: (prefix [n, layers, n_vis, k]: its visual slots' in the
    prefill; words [n, layers, T, k]: BOS's in the prefill, then at decode
    step t the choices of the row that read word t-1 of the caption, found
    by its word and parent row; -1 where no step ran)."""
    routes, steps = kept["routes"], kept.get("decode", [])
    n_moe = len(routes) // (1 + len(steps))
    slots = routes[0].shape[0] // kept["beam"].sequences.shape[0]
    words_in = torch.stack([w for w, _ in steps]).cpu() if steps else None
    parents = torch.stack([p for _, p in steps]).cpu() if steps else None
    served = kept["beam"].sequences[:, 0].cpu()
    length = served.shape[1]
    pre, words = [], []
    for n in pick:
        rows, prev = [], None
        for s in range(len(steps)):
            cand = [r for r in range(n * beam, (n + 1) * beam)
                    if words_in[s, r] == served[n, s] and (prev is None or parents[s, r] == prev)]
            prev = cand[0]
            rows.append(prev)
        layer_pre, layer_words = [], []
        for i in range(n_moe):
            p = routes[i][n * slots:(n + 1) * slots].cpu()
            w = [p[n_vis:n_vis + 1]] + [routes[n_moe * (1 + s) + i][r:r + 1].cpu()
                                        for s, r in enumerate(rows)]
            w = torch.cat(w)
            if w.shape[0] < length:
                w = torch.cat([w, w.new_full((length - w.shape[0], w.shape[1]), -1)])
            layer_pre.append(p[:n_vis])
            layer_words.append(w)
        pre.append(torch.stack(layer_pre))
        words.append(torch.stack(layer_words))
    return torch.stack(pre), torch.stack(words)


def reference_outputs(A: Arith, P, images, pad, cfg: dict, traffic: dict, device, sampled,
                      block: int = 16) -> dict:
    """The reference's projected tokens from the images; from the program's
    projected tokens, its last-layer prefix latents, the log-probs of the
    served tokens (taking the program's expert choices at ties,
    ``traffic["route_tie"]``) and its own beam search's best score.  The
    language model is held from the program's visual tokens because it
    amplifies an input difference: the bf16 vision stack's ~1.3% (as
    ``vis_token_err`` reads) grew to ~3.5% at the last latents, three times
    the language model's own rounding."""
    m, lm = cfg["model"], lm_config(cfg)
    tokens = sampled["tokens"]
    stats: dict = {}
    prev = fp32_context()
    out: dict = {}
    try:
        with torch.no_grad():
            for s in range(0, images.shape[0], block):
                vis = ref_vision.vision(A, P, images[s:s + block].to(device),
                                        pad[s:s + block].to(device), m)
                ref_tokens, mask = ref_lm.project(A, P, vis)
                # the language model reads the program's visual tokens: the
                # vision and projector are held to the reference by
                # vis_token_err, the language model from the same input
                prefix = sampled["vis_tokens"][s:s + block].to(device)
                k = sampled["route_words"].shape[-1]
                routes = [torch.cat([sampled["route_prefix"][s:s + block, i].reshape(-1, k),
                                     sampled["route_words"][s:s + block, i].reshape(-1, k)])
                          .to(device) for i in range(sampled["route_words"].shape[1])]
                served = ref_lm.served_log_probs(A, P, tokens[s:s + block].to(device), prefix,
                                                 mask, lm, m["bos_idx"], routes=routes,
                                                 tie=traffic["route_tie"], stats=stats)
                beam = ref_lm.beam_search(A, P, prefix, mask, lm, beam=traffic["beam_size"],
                                          steps=traffic["beam_len"], bos=m["bos_idx"],
                                          eos=m["eos_idx"])
                part = {"vis_tokens": ref_tokens, "latent": served["latent"],
                        "served": served["served"], "best_score": beam["score"]}
                for name, v in part.items():
                    out.setdefault(name, []).append(v.float().cpu())
    finally:
        restore(prev)
    print(f"gritbench: routing: {stats.get('differ', 0)} of {stats.get('rows', 0)} rows chose "
          f"otherwise than the reference, {stats.get('taken', 0)} within the tie (widest "
          f"{stats.get('widest', 0.0):.3g})", file=sys.stderr)
    out = {name: torch.cat(v) for name, v in out.items()}
    out["route_flip_share"] = stats.get("differ", 0) / max(stats.get("rows", 0), 1)
    return out


def compare(prog: dict, ref: dict, eos: int) -> dict:
    """The numbers compared, each a worst case over the sampled images:

    - ``vis_token_err``, ``latent_err``: the largest relative error ||p - r||
      / ||r|| of an image's projected visual tokens and of its last layer's
      prefix latents, over its real slots (a padded grid slot is never
      attended);
    - ``logprob_gap``: the largest difference between a word log-prob the
      program reports along its beam and the reference's for the same word
      after the same prefix, up to the caption's EOS;
    - ``caption_gap``: the mean over the sampled images of the amount by
      which the reference's score of the served caption lies below the best
      score of the reference's own beam search;
    - ``route_flip_share``: of the routed rows along the served captions
      (every MoE layer, prefix and words), the share whose experts the
      program chose otherwise than the reference (``reference/kimi_lm.py::
      route``)."""
    real = (~prog["prefix_mask"][:, :prog["vis_tokens"].shape[1]]).float()[..., None]
    out = {}
    for key, name in (("vis_token_err", "vis_tokens"), ("latent_err", "latent")):
        p, r = prog[name] * real, ref[name] * real
        out[key] = float(((p - r).flatten(1).norm(dim=1) / r.flatten(1).norm(dim=1)).max())
    tokens = prog["tokens"]
    steps = torch.arange(tokens.shape[1])[None]
    upto = steps < caption_lengths(tokens, eos)[:, None]
    served = (ref["served"] * upto).sum(1)
    out["logprob_gap"] = float(((prog["log_probs"] - ref["served"]).abs() * upto).amax())
    out["caption_gap"] = float((ref["best_score"] - served).mean())
    out["route_flip_share"] = float(ref["route_flip_share"])
    return out


def _reference_values(cell: harness.Cell, prog: LMCaptionRun, sampled: dict) -> dict:
    t_ref = time.perf_counter()
    P = lm_weights.LazyParams(prog.shapes, cell.seed, prog.device,
                              det=cell.config["model"]["detector"])
    ref = reference_outputs(Arith("fp32"), P, sampled["images"], sampled["pad"], cell.config,
                            cell.traffic, prog.device, sampled)
    print(f"gritbench: the reference took {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return compare(sampled, ref, cell.config["model"]["eos_idx"])


def run(cell: harness.Cell) -> dict:
    """One run of the cell -> the parts of the result line and the record
    the per-layer readers read."""
    tr = cell.traffic
    prog = LMCaptionRun(cell)
    prog.build(cell.seed)
    prog.loop(count=tr["warmup_batches"])
    prog._sync()
    if prog.cuda:
        torch.cuda.reset_peak_memory_stats(prog.device)
    prog.keep_index = int(np.random.default_rng(int(cell.seed)).integers(0, 3))
    prog.kept = {}
    before = dict(moe_ops.LAUNCHES)
    prog.steps = 0
    setup_s = time.perf_counter() - harness.START["t"]
    win = prog.loop(seconds=cell.seconds)
    win_launches = {k: moe_ops.LAUNCHES[k] - before[k] for k in before}
    peak = torch.cuda.max_memory_allocated(prog.device) if prog.cuda else 0
    images = win["batches"] * tr["batch"]
    steps = prog.steps / win["batches"]
    rec = {"cell": cell.name, "config": cell.config, "traffic": tr,
           "window": {"seconds": win["seconds"], "units": win["batches"], "images": images,
                      "moe_launches": win_launches},
           "flops_per_unit": counts.batch_flops(cell.config, tr, round(steps)),
           "moe_dims": counts.expert_dims(lm_config(cell.config)),
           "gemm_launches": caption_counts.gemm_launches(cell.config, tr),
           "dtype": cell.config["dtype"], "peak_mem_bytes": peak, "stretch": None}
    if cell.trace:
        rec["stretch"] = prog.stretch()
    sampled = prog.sample(cell.seed)
    prog.free()
    values = _reference_values(cell, prog, sampled)
    lat_ms = sorted(1e3 * x for x in win["latencies"])
    e2e = {"caption_images_per_s": images / win["seconds"],
           "caption_batch_p90_ms": percentile(lat_ms, 0.90)}
    return {"e2e": e2e, "setup_s": setup_s, "attempted": images, "failed": 0,
            "values": values, "record": rec, "memory_peak_bytes": peak}


def _variant(cell: harness.Cell, variant: str) -> dict:
    """The program built as ``variant`` over ``control_batches`` batches,
    judged as a run's program is."""
    tr = cell.traffic
    prog = LMCaptionRun(cell)
    prog.build(cell.seed, variant)
    prog.loop(count=tr["warmup_batches"])
    prog.keep_index = 0
    prog.kept = {}
    prog.loop(count=tr["control_batches"])
    sampled = prog.sample(cell.seed)
    prog.free()
    return _reference_values(cell, prog, sampled)


def control(cell: harness.Cell) -> dict:
    """The program with its routed experts in float8 e4m3, the precision
    below the configuration's bfloat16."""
    return _variant(cell, "fp8_experts")


def fault(cell: harness.Cell) -> dict:
    """The planted fault: five routed experts a token in place of six."""
    return _variant(cell, "top5")


def fault_unbiased(cell: harness.Cell) -> dict:
    """The second planted fault: six routed experts a token, chosen by the
    scores alone, without ``noaux_tc``'s correction bias."""
    return _variant(cell, "unbiased")

