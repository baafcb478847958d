"""What the training drivers share: the window of steps issued back to back,
and the comparison of a step's first three steps with the reference's.

The comparison, by the worst leaf: for each parameter leaf, the gap between
the program's and the reference's norm of (a) the first step's gradient as
the optimizer got it (clipped), read from the optimizer's first moment after
one step, and (b) the parameters' change over the three steps, measured
against the reference's norm of that leaf or of the median leaf, whichever
is larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's (of the leaves the step reaches) are left out of both: they
move by round-off alone, and leaves the step does not reach (frozen, or off
its path) have none.  The
losses of the three steps are compared relatively, and so is the first
step's gradient norm before the clip.
"""

from __future__ import annotations

import sys
import time

import torch

from gritbench import harness, trace as trace_lib
from gritbench.weights import make_weights

#: steps of set-up that the check reads and the reference follows
CHECK_STEPS = 3

#: leaves whose reference gradient norm is under this share of the median
#: leaf's are left out of the leaf comparisons
NOISE_SHARE = 1e-3


def leaf_norms(tensors: dict) -> dict:
    """{name: float norm} of a dict of tensors, in one device call."""
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[n].float() for n in names]))
    return dict(zip(names, norms.cpu().tolist()))


def worst_leaf_gap(prog: dict, ref: dict, keep: list[str]) -> float:
    base = sorted(ref[n] for n in keep)
    median = base[len(base) // 2]
    return max(abs(prog[n] - ref[n]) / max(ref[n], median) for n in keep)


def compare(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"loss" [3], "grad_norm" [3] (a step that clips),
    "first_grad" {leaf: norm}, "change" {leaf: norm}} -> the numbers
    compared."""
    g = ref["first_grad"]
    moved = sorted(v for v in g.values() if v > 0)
    keep = [n for n in g if g[n] >= NOISE_SHARE * moved[len(moved) // 2]]
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))}
    if "grad_norm" in ref:   # a step that clips reads its norm before the clip
        out["grad_norm_gap"] = (abs(prog["grad_norm"][0] - ref["grad_norm"][0])
                                / ref["grad_norm"][0])
    out["grad_leaf_gap"] = worst_leaf_gap(prog["first_grad"], g, keep)
    out["change_leaf_gap"] = worst_leaf_gap(prog["change"], ref["change"], keep)
    return out


def window(step, seconds: float, sync, read, read_every: int) -> dict:
    """Issue ``step(i)`` back to back until ``seconds`` have passed, reading
    back the metrics every ``read_every`` steps as the loops' hooks do, then
    wait for the device -> {"seconds" from the first issue to the device's
    end, "steps"}."""
    n = 0
    t0 = time.perf_counter()
    while n == 0 or time.perf_counter() - t0 < seconds:
        metrics = step(n)
        n += 1
        if n % read_every == 0:
            read(metrics)
    sync()
    return {"seconds": time.perf_counter() - t0, "steps": n}


class TrainRun:
    """A training cell's program for one seed.  A driver's subclass
    ``build``s ``model``, ``state`` (an ``engine.xe.TrainState``), ``step``,
    ``pool``, ``shapes`` and ``mask_seed``, and gives ``args(i)``: the step's
    arguments for pool batch ``i``, moved to the card."""

    def __init__(self, cell: harness.Cell):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(cell.device)
        self.cuda = self.device.type == "cuda"
        self.spans = False

    def ranged(self, step):
        """``step`` inside a ``gritbench.train_step`` range in the stretch."""
        def call(*a):
            if not self.spans:
                return step(*a)
            with torch.profiler.record_function("gritbench.train_step"):
                return step(*a)
        return call

    def one_step(self, i: int) -> dict:
        self.state, metrics = self.step(self.state, *self.args(i))
        return metrics

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def check_steps(self, seed: int) -> dict:
        """The first three steps, on pool batches 0, 1, 2 -> each step's loss
        (and gradient norm where the step reports one), the first step's
        gradient per leaf from the optimizer's first moment (a leaf without
        one had no gradient), each leaf's change over the three steps."""
        params = dict(self.state.model.named_parameters())
        b1 = self.state.optimizer.param_groups[0]["betas"][0]
        got: dict = {}
        for i in range(CHECK_STEPS):
            metrics = self.one_step(i)
            for key in ("loss", "grad_norm"):
                if key in metrics:
                    got.setdefault(key, []).append(metrics[key])
            if i == 0:
                state = self.state.optimizer.state
                got["first_grad"] = {n: v / (1 - b1) for n, v in leaf_norms(
                    {n: state[p]["exp_avg"] if "exp_avg" in state.get(p, {})
                     else torch.zeros_like(p) for n, p in params.items()}).items()}
        w0 = make_weights(self.shapes, seed, self.device, det=self.cfg["model"]["detector"])
        with torch.no_grad():
            got["change"] = leaf_norms({n: p - w0[n] for n, p in params.items()})
        del w0
        for key in ("loss", "grad_norm"):
            if key in got:
                got[key] = [float(x) for x in got[key]]
        return got

    def stretch(self) -> dict:
        k = self.traffic["trace_steps"]

        def body():
            for i in range(k):
                self.one_step(i)
            self.sync()

        return trace_lib.stretch(body, k, self)

    def free(self) -> None:
        del self.state, self.step
        if self.cuda:
            self.sync()
            torch.cuda.empty_cache()


def run_cell(cell: harness.Cell, prog: TrainRun, counts, reference) -> dict:
    """One run of a training cell: set-up and the three check steps, the
    window, the stretch, then ``reference(cell, shapes, batches,
    mask_seed)``'s three steps and the comparison."""
    tr = cell.traffic
    prog.build(cell.seed)
    got = prog.check_steps(cell.seed)
    prog.sync()
    if prog.cuda:
        torch.cuda.reset_peak_memory_stats(prog.device)
    setup_s = time.perf_counter() - harness.START["t"]
    win = window(lambda n: prog.one_step(CHECK_STEPS + n), cell.seconds, prog.sync,
                 lambda metrics: float(metrics["loss"]), tr["read_every"])
    peak = torch.cuda.max_memory_allocated(prog.device) if prog.cuda else 0
    images = win["steps"] * tr["batch"]
    rec = {"cell": cell.name, "config": cell.config, "traffic": tr,
           "window": {"seconds": win["seconds"], "units": win["steps"], "images": images},
           "flops_per_unit": counts.step_flops(cell.config, tr),
           "gemm_launches": counts.gemm_launches(cell.config, tr),
           "dtype": cell.config["dtype"], "peak_mem_bytes": peak, "stretch": None}
    if cell.trace:
        rec["stretch"] = prog.stretch()
    shapes, mask_seed, batches = prog.shapes, prog.mask_seed, prog.pool[:CHECK_STEPS]
    prog.free()
    t_ref = time.perf_counter()
    values = compare(got, reference(cell, shapes, batches, mask_seed))
    print(f"gritbench: the reference took {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    return {"e2e": {"train_images_per_s": images / win["seconds"]}, "setup_s": setup_s,
            "attempted": images, "failed": 0, "values": values, "record": rec,
            "memory_peak_bytes": peak}


def reference_readings(out: dict, w0: dict) -> dict:
    """A reference's three steps -> the readings ``compare`` takes."""
    with torch.no_grad():
        change = leaf_norms({n: out["params"][n] - w0[n] for n in w0})
    first = {n: 0.0 for n in w0}
    first.update(leaf_norms(out["first_grad"]))
    got = {"loss": out["loss"], "first_grad": first, "change": change}
    if "grad_norm" in out:
        got["grad_norm"] = out["grad_norm"]
    return got


def against_reference(cell: harness.Cell, shapes, batches, reference, **arm) -> dict:
    """An arm in the program's place (the reference with ``arm``: a lower
    precision, or a planted fault) judged by ``compare`` against the float32
    reference on the same three steps."""
    mask_seed = int(cell.seed) + 1
    return compare(reference(cell, shapes, batches, mask_seed, **arm),
                   reference(cell, shapes, batches, mask_seed))
