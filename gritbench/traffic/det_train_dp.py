"""Driver ``det_train_dp``: ``det_train``'s detector pre-training steps on
``ranks`` ranks, one card a rank, under the port's data parallel
(``parallel.mesh.wrap_data_parallel``: DDP over NCCL), issued back to back
as the trainer issues them.

The command's process starts the ranks through the port's
``parallel.distributed.run_ranks`` and waits for them; it touches no card
until they have exited.  Each rank builds ``det_train``'s state with the
model wrapped in DDP as ``train_detector.py`` wraps it: the same weights
from the seed on every rank, its own pool of batches drawn from seed + rank
(rank 0's is ``det_train``'s for the seed) and its own dropout and
drop-path masks from a generator seeded with seed + 1 + rank.  The ranks
run the three check steps, then the window in lockstep: every collective
needs every rank, so rank 0 alone reads its clock, and its decision to stop
rides on the read-back every ``read_every`` steps, which sums the step's
metrics over the ranks as the trainer's log hook does.  Under
``--trace 1`` every rank runs the stretch's steps and rank 0 profiles them:
rank 0's record feeds the readers, and its ``flops_per_unit`` is one
rank's step.  The ranks hand their results back through ``run_ranks``'
files, with the banned modules (``harness.BANNED``) that each holds once
its window and stretch have run: the run stops on any.

The check, once the ranks have exited: the float32 reference of the global
step (``gritbench/reference/detection.py::global_steps``) on card 0, one
rank's share at a time, from the same weights and the same batches and
masks, against rank 0's readings: the losses summed over the ranks, the
gradient norm and the first gradient after DDP's average, each leaf's
change over the three steps.
"""

from __future__ import annotations

import sys
import time

import torch

from gritbench import harness, program, training
from gritbench.counts import detection as counts
from gritbench.reference import detection as ref_det
from gritbench.reference.nn import Arith, fp32_context, restore
from gritbench.traffic import det_train
from gritbench.weights import make_weights

#: the name DDP puts before each parameter of the module it wraps
DDP_PREFIX = "module."
TARGETS = ("labels", "boxes", "valid")
#: seconds a run's ranks may take beyond the window: set-up (the first run
#: in a checkout builds the kernels), the window's last read-back, the
#: stretch and the teardown
RANK_SLACK_S = 1100.0


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s pool (rank 0's is the cell's)."""
    return seed + rank


def mask_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout and drop-path generator (rank 0's
    is ``det_train``'s)."""
    return seed + 1 + rank


def pool_sums(batches) -> list[float]:
    """A cheap fingerprint of batches, so that the reference's copies of the
    ranks' pools are known to be the ones the ranks drew."""
    return [float(b["images"].sum(dtype=torch.int64)) + float(b["boxes"].double().sum())
            for b in batches]


class DPRun(det_train.DetRun):
    """``DetRun`` for one rank, its model under DDP."""

    def __init__(self, cell: harness.Cell, rank: int):
        super().__init__(cell)
        self.rank = rank

    def build(self, seed: int) -> None:
        from grit_tpu_torch.detection import solver
        from grit_tpu_torch.detection.detector import build_detection_model
        from grit_tpu_torch.engine import optim, xe
        from grit_tpu_torch.parallel.mesh import wrap_data_parallel
        from grit_tpu_torch.utils.nested import ImageBatch

        pc = program.detection_config(self.cfg)
        model, crit = build_detection_model(pc, None, device=self.device, seed=None)
        self.shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        model.load_state_dict(make_weights(self.shapes, seed, self.device,
                                           det=self.cfg["model"]["detector"]))
        o = pc.optimizer
        opt = optim.build_detector_optimizer(
            model, lr=o.lr, lr_backbone=o.lr_backbone, sp_lr=o.sp_lr,
            weight_decay=o.weight_decay, sp_names=list(o.sp_names))
        self.pool = det_train.pool(self.traffic, self.cfg, rank_seed(seed, self.rank),
                                   self.device)
        first = self.pool[0]
        probe = solver.detector_probe(crit, [{"samples": ImageBatch(first["images"],
                                                                    first["pad"]),
                                              "targets": {k: first[k] for k in TARGETS}}])
        model = wrap_data_parallel(
            model, self.device, trained=[p for g in opt.param_groups for p in g["params"]],
            probe=probe)
        self.mask_seed = mask_seed(seed, self.rank)
        self.state = xe.TrainState(model, opt, global_steps=0, generator=torch.Generator(
            device=self.device).manual_seed(self.mask_seed))
        self.step = self.ranged(solver.make_detector_train_step(crit,
                                                                clip_max_norm=o.clip_max_norm))

    def check_steps(self, seed: int) -> dict:
        """``TrainRun.check_steps`` under DDP's parameter names, read back
        in the model's own; each step's loss summed over the ranks."""
        from grit_tpu_torch.parallel.mesh import global_sum

        shapes = self.shapes
        # DDP's names: ``make_weights`` draws the same tensors under them
        self.shapes = [(DDP_PREFIX + n, s) for n, s in shapes]
        try:
            got = super().check_steps(seed)
        finally:
            self.shapes = shapes
        for key in ("first_grad", "change"):
            got[key] = {n.removeprefix(DDP_PREFIX): v for n, v in got[key].items()}
        got["loss"] = global_sum(torch.tensor(got["loss"], device=self.device)).tolist()
        return got


def window(prog: DPRun, seconds: float, read_every: int) -> dict:
    """``training.window`` in lockstep: steps issued back to back; every
    ``read_every`` steps the step's metrics and rank 0's verdict on its
    clock are summed over the ranks in one exchange, and every rank stops
    once rank 0 has seen ``seconds`` pass -> {"seconds" on rank 0's clock
    from the first issue to the device's end after a final barrier,
    "steps", "t0" (the first issue)}."""
    from grit_tpu_torch.parallel.distributed import barrier
    from grit_tpu_torch.parallel.mesh import global_sum

    n = 0
    t0 = time.perf_counter()
    while True:
        metrics = prog.one_step(training.CHECK_STEPS + n)
        n += 1
        if n % read_every:
            continue
        stop = prog.rank == 0 and time.perf_counter() - t0 >= seconds
        flag = torch.tensor([float(stop)], device=prog.device)
        read = global_sum(torch.cat([torch.stack([metrics[k].float() for k in metrics]),
                                     flag])).tolist()
        if read[-1] > 0:
            break
    prog.sync()
    barrier("window")
    prog.sync()
    return {"seconds": time.perf_counter() - t0, "steps": n, "t0": t0}


def rank_run(cell: harness.Cell) -> dict:
    """One rank's part of a run (``run_ranks`` calls it in each rank) ->
    what the command's process needs of it, on the host."""
    from grit_tpu_torch.parallel.distributed import barrier, rank, rank_device

    marks = [time.perf_counter()]   # set-up: entered, built, checked, past the barrier
    prev = fp32_context()     # the configuration computes in float32: no TF32
    try:
        cell.device = str(rank_device(cell.device))
        prog = DPRun(cell, rank())
        prog.build(cell.seed)
        prog.sync()
        marks.append(time.perf_counter())
        got = prog.check_steps(cell.seed)
        prog.sync()
        marks.append(time.perf_counter())
        barrier("set-up")
        marks.append(time.perf_counter())
        if prog.cuda:
            torch.cuda.reset_peak_memory_stats(prog.device)
        win = window(prog, cell.seconds, cell.traffic["read_every"])
        peak = torch.cuda.max_memory_allocated(prog.device) if prog.cuda else 0
        out = {"steps": win["steps"], "peak": peak, "marks": marks,
               "sums": pool_sums(prog.pool[:training.CHECK_STEPS])}
        stretch = None
        if cell.trace and prog.rank == 0:
            stretch = prog.stretch()
        elif cell.trace:           # rank 0's collectives need the other ranks' steps
            for i in range(cell.traffic["trace_steps"]):
                prog.one_step(i)
            prog.sync()
        if prog.rank == 0:
            tr = cell.traffic
            out.update(readings=got, shapes=prog.shapes, t0=win["t0"], record={
                "cell": cell.name, "config": cell.config, "traffic": tr,
                "window": {"seconds": win["seconds"], "units": win["steps"],
                           "images": win["steps"] * tr["batch"] * tr["ranks"]},
                "flops_per_unit": counts.step_flops(cell.config, tr),
                "gemm_launches": counts.gemm_launches(cell.config, tr),
                "dtype": cell.config["dtype"], "peak_mem_bytes": peak, "stretch": stretch})
        prog.free()
        # the window and the stretch ran here: this process's modules are the run's
        out["banned"] = harness.banned_loaded()
        return out
    finally:
        restore(prev)


def reference_steps(cell: harness.Cell) -> list[list[dict]]:
    """The check steps' batches of every rank, ``[step][rank]``, drawn again
    from the seed in host memory, as the ranks drew them."""
    dev = torch.device(cell.device)
    pools = [det_train.pool(cell.traffic, cell.config, rank_seed(cell.seed, r), dev)
             for r in range(cell.traffic["ranks"])]
    return [[p[i] for p in pools] for i in range(training.CHECK_STEPS)]


def reference(cell: harness.Cell, shapes, steps, arith: str = "fp32", **fault) -> dict:
    """The reference's three global steps on ``steps`` (host dicts) -> the
    readings ``training.compare`` takes."""
    dev = torch.device(cell.device)
    w0 = make_weights(shapes, cell.seed, dev, det=cell.config["model"]["detector"])
    on_dev = [[(b["images"].to(dev), b["pad"].to(dev), {k: b[k].to(dev) for k in TARGETS})
               for b in shares] for shares in steps]
    seeds = [mask_seed(cell.seed, r) for r in range(cell.traffic["ranks"])]
    prev = fp32_context()
    try:
        out = ref_det.global_steps(Arith(arith), w0, on_dev, cell.config, seeds, dev, **fault)
    finally:
        restore(prev)
    return training.reference_readings(out, w0)


def run(cell: harness.Cell) -> dict:
    prev = fp32_context()     # the ranks take this process's float32 settings
    launched = time.perf_counter()
    try:
        ranks = start_ranks(cell)
    finally:
        restore(prev)
    for r, got in enumerate(ranks):
        if got["banned"]:
            sys.exit(f"gritbench: rank {r} loaded {', '.join(got['banned'])}: the benchmark "
                     "measures the PyTorch port alone")
    print(setup_phases(launched, [r["marks"] for r in ranks]), file=sys.stderr)
    r0 = ranks[0]
    if len({r["steps"] for r in ranks}) != 1:
        raise RuntimeError("det_train_dp: the ranks ran different numbers of steps: "
                           + ", ".join(str(r["steps"]) for r in ranks))
    rec = r0["record"]
    steps = reference_steps(cell)
    for r, got in enumerate(ranks):
        if pool_sums([s[r] for s in steps]) != got["sums"]:
            raise RuntimeError(f"det_train_dp: rank {r}'s batches differ from the "
                               "reference's copies drawn from the same seed")
    t_ref = time.perf_counter()
    values = training.compare(r0["readings"], reference(cell, r0["shapes"], steps))
    print(f"gritbench: the reference took {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    images = rec["window"]["images"]
    # perf_counter is the system's monotonic clock: rank 0's readings and
    # this process's start are on one time line
    return {"e2e": {"train_images_per_s": images / rec["window"]["seconds"]},
            "setup_s": r0["t0"] - harness.START["t"], "attempted": images, "failed": 0,
            "values": values, "record": rec, "memory_peak_bytes": max(r["peak"] for r in ranks)}


def setup_phases(launched: float, marks: list[list[float]]) -> str:
    """Where the set-up went, in seconds from the command's start: the ranks'
    launch, then each rank's entry (its process, imports and process
    group), state built, check steps done and set-up barrier passed."""
    t = harness.START["t"]
    return (f"gritbench: set-up (s from the command's start): ranks launched "
            f"{launched - t:.2f}; rank entered / built / checked / past the barrier: "
            + "; ".join(f"{r} " + " / ".join(f"{m - t:.2f}" for m in ms)
                        for r, ms in enumerate(marks)))


def start_ranks(cell: harness.Cell) -> list[dict]:
    """``rank_run`` in ``ranks`` fresh processes, one card each (gloo on
    the CPU) -> their results in rank order."""
    from grit_tpu_torch.parallel import distributed

    cuda = torch.device(cell.device).type == "cuda"
    return distributed.run_ranks(
        "gritbench.traffic.det_train_dp:rank_run", cell.traffic["ranks"], args=(cell,),
        device=cell.device, backend="nccl" if cuda else "gloo",
        deadline=cell.seconds + RANK_SLACK_S)


def arm(name: str, ranks: int) -> dict:
    """The reference's options of an arm read in the program's place: the
    control (every product's operands rounded to TF32) or a planted
    fault."""
    return {"control": {"arith": "tf32"},
            "fault": {"leave_out": ranks - 1},     # the last rank's gradient left out
            "half_fault": {"half": True}}[name]


def arms(cell: harness.Cell, names) -> dict:
    """Each arm of ``names`` judged by ``training.compare`` against the
    float32 reference on the same three global steps, run once."""
    from grit_tpu_torch.detection.detector import build_detection_model

    dev = torch.device(cell.device)
    model, _ = build_detection_model(program.detection_config(cell.config), None, device=dev,
                                     seed=None)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    del model
    steps = reference_steps(cell)
    ref = reference(cell, shapes, steps)
    return {n: training.compare(reference(cell, shapes, steps,
                                          **arm(n, cell.traffic["ranks"])), ref)
            for n in names}


def control(cell: harness.Cell) -> dict:
    """The control in the program's place: the reference's three global
    steps with every product's operands rounded to TF32."""
    return arms(cell, ["control"])["control"]


def fault(cell: harness.Cell) -> dict:
    """The data-parallel fault, planted in the reference put in the
    program's place: one rank's gradient left out of the average."""
    return arms(cell, ["fault"])["fault"]
