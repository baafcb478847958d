"""Driver ``caption_generate``: caption batches through the port's
``engine.evaluator.make_caption_generator`` in a closed loop, as
``evaluate_metrics`` issues them (batch i+1 is issued before batch i's
tokens are read on the host).

Set-up builds the captioner on the card with the benchmark's weights from
the seed (``gritbench/weights.py``), rounds them to the configuration's
type, makes a pool of uint8 image batches on the card from the seed and
keeps it in pinned host memory, and runs the warm-up batches.  Each batch of
the window is copied to the card inside the window.  A batch's latency runs
from its issue to its tokens reaching the host (a thread waits on an event
after the tokens' copy and reads the host clock).

The check: for a sample drawn from the seed of two finished batches (one
early, and the last), the port's visual features, the word log-probs along
the beam it chose and its captions are compared with the float32 reference
(``gritbench/reference``) on the same images and weights, once the window
has closed and the program is freed.
"""

from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from gritbench import harness, inputs, program, trace as trace_lib
from gritbench.counts import caption as counts
from gritbench.reference import caption as ref_caption, vision as ref_vision
from gritbench.reference.nn import Arith, fp32_context, restore
from gritbench.weights import make_weights

class Arrivals:
    """The host clock when each batch's tokens reached the host: a thread
    waits on the event recorded after each copy (on the CPU the copy is
    done when it returns)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.done: dict[int, float] = {}
        self.cond = threading.Condition()
        self.q: queue.Queue = queue.Queue()
        self.thread = None
        if cuda:
            self.thread = threading.Thread(target=self._wait_loop, daemon=True)
            self.thread.start()

    def _wait_loop(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            i, ev = item
            ev.synchronize()
            t = time.perf_counter()
            with self.cond:
                self.done[i] = t
                self.cond.notify_all()

    def put(self, i: int) -> None:
        if not self.cuda:
            self.done[i] = time.perf_counter()
            return
        ev = torch.cuda.Event()
        ev.record()
        self.q.put((i, ev))

    def wait(self, i: int) -> float:
        with self.cond:
            while i not in self.done:
                self.cond.wait()
            return self.done.pop(i)

    def close(self) -> None:
        if self.thread is not None:
            self.q.put(None)
            self.thread.join(timeout=60)


def image_pool(traffic: dict, seed: int, device) -> list:
    """``pool_batches`` image batches drawn from the seed
    (``gritbench/inputs.py``), as the port's ``ImageBatch``es on the host."""
    from grit_tpu_torch.utils.nested import ImageBatch

    gen = inputs.generator(seed, 17, device)
    pool = []
    for _ in range(traffic["pool_batches"]):
        imgs, pad = inputs.images(traffic, gen, device)
        host = inputs.to_host({"images": imgs, "pad": pad})
        pool.append(ImageBatch(host["images"], host["pad"]))
    return pool


class CaptionRun:
    """The program under test, its pool and its window, for one seed."""

    def __init__(self, cell: harness.Cell):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(cell.device)
        self.cuda = self.device.type == "cuda"
        self.spans = False
        self.cur: dict = {}       # the outputs of the batch under way
        self.kept: dict = {}      # "early" (batch keep_index) and "last"
        self.keep_index = -1

    # ------------------------------------------------------------ set-up
    def build(self, seed: int) -> None:
        from grit_tpu_torch.engine import evaluator
        from grit_tpu_torch.models.captioner import build_captioner, to_compute_dtype

        m = self.cfg["model"]
        model = build_captioner(program.caption_config(self.cfg), device=self.device,
                                dtype=torch.float32, seed=None)
        self.shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        weights = make_weights(self.shapes, seed, self.device, det=m["detector"])
        model.load_state_dict(weights)
        del weights
        self.model = to_compute_dtype(model, program.DTYPES[self.cfg["dtype"]]).eval()
        self._instrument(evaluator)
        self.generate = evaluator.make_caption_generator(
            self.model, beam_size=self.traffic["beam_size"], max_len=self.traffic["beam_len"],
            bos_idx=m["bos_idx"], eos_idx=m["eos_idx"])
        self.pool = image_pool(self.traffic, seed, self.device)

    def _instrument(self, evaluator) -> None:
        """Keep the outputs of each batch's layers (references only) and, in
        the profiled stretch, wrap the calls into each layer in a range."""
        model = self.model
        rf = torch.profiler.record_function

        def ranged(name, fn):
            def call(*a, **k):
                if not self.spans:
                    return fn(*a, **k)
                with rf(name):
                    return fn(*a, **k)
            return call

        def det_hook(_mod, _inp, out):
            self.cur.update(swin_grid=out["gri_feat"], gri_mask=out["gri_mask"],
                            reg_feat=out["reg_feat"])

        def grid_hook(_mod, _inp, out):
            self.cur["gri_feat"] = out[0][:, -1]

        def dec_hook(_mod, _inp, out):
            self.cur["region_l1"] = out[0][1]

        model.detector.register_forward_hook(det_hook)
        model.detector.det_module.register_forward_hook(dec_hook)
        model.grid_net.register_forward_hook(grid_hook)
        model.compute_vis = ranged("gritbench.compute_vis", model.compute_vis)
        model.precompute_vis_kv = ranged("gritbench.precompute_vis_kv", model.precompute_vis_kv)
        self._evaluator = evaluator
        self._beam_search = evaluator.beam_search
        search = ranged("gritbench.beam_search", self._beam_search)

        def beam_search(*a, **k):
            res = search(*a, **k)
            self.cur["beam"] = res
            return res

        evaluator.beam_search = beam_search

    def close(self) -> None:
        self._evaluator.beam_search = self._beam_search

    # ------------------------------------------------------------ the loop
    def loop(self, *, seconds: float | None = None, count: int | None = None) -> dict:
        """Issue batches until ``seconds`` have passed (or ``count`` batches)
        -> {"seconds" from the first issue to the last tokens on the host,
        "batches", "latencies" [s]}."""
        b = self.traffic["batch"]
        arrivals = Arrivals(self.cuda)
        lat, pending, n = [], None, 0
        t_start = t_end = time.perf_counter()

        def consume(item):
            i, t_issue = item
            t = arrivals.wait(i)
            lat.append(t - t_issue)
            return t

        try:
            while True:
                t_issue = time.perf_counter()
                if (count is not None and n >= count) or (
                        seconds is not None and n > 0 and t_issue - t_start >= seconds):
                    break
                self.cur = {}
                images = self.pool[n % len(self.pool)].to(self.device)
                out = self.generate(images, b)
                # the tokens to the host, as the evaluator reads them
                torch.empty(out.shape, dtype=out.dtype, pin_memory=self.cuda).copy_(
                    out, non_blocking=True)
                arrivals.put(n)
                if n == self.keep_index:
                    self.kept["early"] = dict(self.cur, index=n)
                self.kept["last"] = dict(self.cur, index=n)
                if pending is not None:
                    consume(pending)
                pending = (n, t_issue)
                n += 1
            if pending is not None:
                t_end = consume(pending)
        finally:
            arrivals.close()
        self.kept.setdefault("early", self.kept["last"])
        return {"seconds": t_end - t_start, "batches": n, "latencies": lat}

    def stretch(self) -> dict:
        """The profiled stretch: ``trace_batches`` batches, each layer's calls
        in a range, with the launch counters read around it."""
        k = self.traffic["trace_batches"]
        return trace_lib.stretch(lambda: (self.loop(count=k), self._sync()), k, self)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ the check
    def sample(self, seed: int) -> dict:
        """The program's outputs for the sampled images of the kept batches,
        on the host: the longest caption of each batch and others drawn from
        the seed."""
        rng = np.random.default_rng(int(seed) + 1)
        eos = self.cfg["model"]["eos_idx"]
        per = self.traffic["sample_images"]
        rows, seen = [], set()
        for slot in ("early", "last"):
            k = self.kept[slot]
            if k["index"] in seen:
                continue
            seen.add(k["index"])
            length = caption_lengths(k["beam"].sequences[:, 0].cpu(), eos)
            pick = [int(length.argmax())]
            others = [i for i in rng.permutation(length.shape[0]) if i != pick[0]]
            pick += [int(i) for i in others[:per - 1]]
            rows.append((k, pick))
        out = {name: [] for name in ("swin_grid", "gri_feat", "gri_mask", "region_l1", "reg_feat",
                                     "tokens", "log_probs", "images", "pad")}
        for k, pick in rows:
            dev = k["region_l1"].device
            idx = torch.tensor(pick, device=dev)
            for name in ("swin_grid", "gri_feat", "region_l1", "reg_feat"):
                out[name].append(k[name][idx].float().cpu())
            out["gri_mask"].append(k["gri_mask"][idx].cpu())
            out["tokens"].append(k["beam"].sequences[idx, 0].cpu())
            out["log_probs"].append(k["beam"].log_probs[idx, 0].float().cpu())
            batch = self.pool[k["index"] % len(self.pool)]
            out["images"].append(batch.images[idx.cpu()])
            out["pad"].append(batch.mask[idx.cpu()])
        return {name: torch.cat(v) for name, v in out.items()}

    def free(self) -> None:
        self.close()
        del self.model, self.generate, self.kept, self.cur
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def caption_lengths(tokens: torch.Tensor, eos: int) -> torch.Tensor:
    """Tokens up to and including the first EOS (all of them without one)."""
    t = tokens.shape[1]
    is_eos = tokens == eos
    first = torch.where(is_eos.any(1), is_eos.int().argmax(1), torch.full_like(tokens[:, 0], t - 1))
    return first + 1


def reference_outputs(A: Arith, P: dict, images, pad, cfg: dict, traffic: dict, device,
                      tokens=None, block: int = 16) -> dict:
    """The reference's visual features and, for served ``tokens``, their
    log-probs; without ``tokens`` (the control in the program's place), its
    own beam search's tokens and log-probs.  Always its own beam search's
    best score."""
    m = dict(cfg["model"], beam_size=traffic["beam_size"], beam_len=traffic["beam_len"])
    prev = fp32_context()
    out = {}
    try:
        with torch.no_grad():
            for s in range(0, images.shape[0], block):
                im = images[s:s + block].to(device)
                pd = pad[s:s + block].to(device)
                vis = ref_vision.vision(A, P, im, pd, m)
                beam = ref_caption.beam_search(A, P, vis, m)
                part = {"swin_grid": vis["swin_grid"], "gri_feat": vis["gri_feat"],
                        "region_l1": vis["region_l1"], "reg_feat": vis["reg_feat"],
                        "gri_mask": vis["gri_mask"],
                        "best_score": beam["score"]}
                if tokens is None:
                    part["tokens"], part["log_probs"] = beam["tokens"], beam["log_probs"]
                else:
                    tk = tokens[s:s + block].to(device)
                    part["served"] = ref_caption.served_log_probs(A, P, tk, vis, m)
                for name, v in part.items():
                    out.setdefault(name, []).append(
                        v.float().cpu() if v.is_floating_point() else v.cpu())
    finally:
        restore(prev)
    return {name: torch.cat(v) for name, v in out.items()}


def compare(prog: dict, ref: dict, eos: int) -> dict:
    """The numbers compared, each a worst case over the sampled images:

    - ``swin_grid_err``, ``grid_net_err``, ``region_l1_err``, ``region_err``:
      the largest relative error ||p - r|| / ||r|| of an image's Swin grid
      map, grid network output (both over the image's real tokens), the
      first deformable decoder layer's queries and the last one's (the
      region features);
    - ``logprob_gap``: the largest difference between a word log-prob the
      program reports along its beam and the reference's for the same word
      after the same prefix, up to the caption's EOS;
    - ``caption_gap``: the mean over the sampled images of the amount by
      which the reference's score of the served caption lies below the best
      score of the reference's own beam search (beam search is a search: a
      sound program's caption may score a little above or below it; the
      widest image's gap swings from seed to seed, a control's included)."""
    real = ~prog["gri_mask"].reshape(prog["gri_mask"].shape[0], -1)
    out = {}
    for key, name, mask in (("swin_grid_err", "swin_grid", real),
                            ("grid_net_err", "gri_feat", real),
                            ("region_l1_err", "region_l1", None),
                            ("region_err", "reg_feat", None)):
        p, r = prog[name], ref[name]
        if mask is not None:
            p, r = p * mask[..., None], r * mask[..., None]
        out[key] = float(((p - r).flatten(1).norm(dim=1) / r.flatten(1).norm(dim=1)).max())
    tokens = prog["tokens"]
    steps = torch.arange(tokens.shape[1])[None]
    upto = steps < caption_lengths(tokens, eos)[:, None]
    served = (ref["served"] * upto).sum(1)
    out["logprob_gap"] = float(((prog["log_probs"] - ref["served"]).abs() * upto).amax())
    out["caption_gap"] = float((ref["best_score"] - served).mean())
    return out


def run(cell: harness.Cell) -> dict:
    """One run of the cell -> the parts of the result line and the record
    the per-layer readers read."""
    tr = cell.traffic
    prog = CaptionRun(cell)
    prog.build(cell.seed)
    prog.loop(count=tr["warmup_batches"])
    prog._sync()
    if prog.cuda:
        torch.cuda.reset_peak_memory_stats(prog.device)
    prog.keep_index = int(np.random.default_rng(int(cell.seed)).integers(0, 3))
    prog.kept = {}
    before = trace_lib.snapshot()
    setup_s = time.perf_counter() - harness.START["t"]
    win = prog.loop(seconds=cell.seconds)
    win_deltas = trace_lib.deltas(before, trace_lib.snapshot())
    peak = torch.cuda.max_memory_allocated(prog.device) if prog.cuda else 0
    images = win["batches"] * tr["batch"]
    layers = cell.config["model"]["decoder_layers"]
    steps = win_deltas["decode_tail"] / layers / win["batches"] if prog.cuda else tr["beam_len"]
    rec = {"cell": cell.name, "config": cell.config, "traffic": tr,
           "window": {"seconds": win["seconds"], "units": win["batches"], "images": images},
           "flops_per_unit": counts.batch_flops(cell.config, tr, round(steps)),
           "gemm_launches": counts.gemm_launches(cell.config, tr),
           "dtype": cell.config["dtype"], "peak_mem_bytes": peak, "stretch": None}
    if cell.trace:
        rec["stretch"] = prog.stretch()
    sampled = prog.sample(cell.seed)
    prog.free()
    t_ref = time.perf_counter()
    P = make_weights(prog.shapes, cell.seed, prog.device, det=cell.config["model"]["detector"])
    ref = reference_outputs(Arith("fp32"), P, sampled["images"], sampled["pad"], cell.config,
                            tr, prog.device, tokens=sampled["tokens"])
    values = compare(sampled, ref, cell.config["model"]["eos_idx"])
    print(f"gritbench: the reference took {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    lat_ms = sorted(1e3 * x for x in win["latencies"])
    e2e = {"caption_images_per_s": images / win["seconds"],
           "caption_batch_p90_ms": percentile(lat_ms, 0.90)}
    return {"e2e": e2e, "setup_s": setup_s, "attempted": images, "failed": 0,
            "values": values, "record": rec, "memory_peak_bytes": peak}


def control(cell: harness.Cell) -> dict:
    """The control in the program's place: the reference computed with every
    product's operands in float8 e4m3 (the precision below the
    configuration's bfloat16), on images of the seed's pool, judged by
    ``compare`` as the program is."""
    from grit_tpu_torch.models.captioner import build_captioner

    tr, m = cell.traffic, cell.config["model"]
    dev = torch.device(cell.device)
    model = build_captioner(program.caption_config(cell.config), device=dev,
                            dtype=torch.float32, seed=None)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model
    pool = image_pool(tr, cell.seed, dev)
    rng = np.random.default_rng(int(cell.seed) + 1)
    images, pad = [], []
    for slot in rng.choice(len(pool), size=min(tr["sample_batches"], len(pool)), replace=False):
        idx = torch.from_numpy(rng.permutation(tr["batch"])[:tr["sample_images"]])
        images.append(pool[slot].images[idx])
        pad.append(pool[slot].mask[idx])
    images, pad = torch.cat(images), torch.cat(pad)
    P = make_weights(shapes, cell.seed, dev, det=m["detector"])
    ctl = reference_outputs(Arith("fp8"), P, images, pad, cell.config, tr, dev)
    ref = reference_outputs(Arith("fp32"), P, images, pad, cell.config, tr, dev,
                            tokens=ctl["tokens"])
    return compare(ctl, ref, m["eos_idx"])


def percentile(sorted_values: list[float], q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    if len(sorted_values) == 1:
        return sorted_values[0]
    pos = q * (len(sorted_values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (pos - lo)
