"""The data-parallel detector cell: the NCCL readers on synthetic traces,
the cell's traffic beside ``det_b4``'s, the global-step reference over
shares beside the one-card step over their union, and a rehearsal of the
driver at a tiny size over four gloo ranks on the CPU: rank 0's readings
inside the limits against the global step, the control and the planted
faults (in the reference put in the program's place, and in the ranks'
program) coming out not correct, and a rank that loads JAX stopping the
run."""

from __future__ import annotations

import copy
import textwrap

import pytest
import torch

from gritbench import harness
from gritbench import trace as T
from gritbench.collectives import allreduce_exposed_ms, allreduce_ms
from gritbench.tests import tiny


def kernel(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur, "tid": 7}


def record(kernels, units=1):
    events = [{"ph": "X", "name": T.STRETCH, "cat": "user_annotation", "ts": 0, "dur": 1000,
               "tid": 1}] + kernels
    return {"stretch": {"trace": T.Trace(events), "units": units, "deltas": {}, "lost": []}}


NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"


@pytest.mark.parametrize("case, total, exposed", [
    ("alone", 100.0, 100.0),
    ("under", 100.0, 0.0),
    ("partly", 100.0, 40.0),
    ("two_steps", 100.0, 50.0),
])
def test_nccl_readers(case, total, exposed):
    """NCCL alone, under one compute kernel, partly under two that overlap
    each other, and over two steps (ms a step)."""
    ks = {"alone": [kernel(NCCL, 100, 100), kernel("gemm_f32_kernel", 300, 50)],
          "under": [kernel("gemm_f32_kernel", 50, 300), kernel(NCCL, 100, 100)],
          "partly": [kernel("gemm_f32_kernel", 50, 80), kernel("elementwise", 120, 40),
                     kernel(NCCL, 100, 100)],
          "two_steps": [kernel(NCCL, 100, 100), kernel("win_attn", 150, 50),
                        kernel(NCCL, 400, 100), kernel("win_attn", 400, 50)]}[case]
    rec = record(ks, units=2 if case == "two_steps" else 1)
    assert allreduce_ms(rec) * 1e3 == pytest.approx(total)
    assert allreduce_exposed_ms(rec) * 1e3 == pytest.approx(exposed)
    assert allreduce_exposed_ms(rec) <= allreduce_ms(rec)


def test_nccl_readers_silent_without_nccl():
    rec = record([kernel("gemm_f32_kernel", 100, 100)])
    assert allreduce_ms(rec) is None and allreduce_exposed_ms(rec) is None
    lost = record([kernel(NCCL, 100, 100)])
    lost["stretch"]["lost"] = ["gemm_f32: 0 kernels in the trace, 1 launched"]
    assert allreduce_ms(lost) is None and allreduce_exposed_ms(lost) is None


def test_traffic_is_det_b4_on_ranks():
    one = harness.read_json(harness.ROOT / "traffic" / "det_b4.json")
    dp = harness.read_json(harness.ROOT / "traffic" / "det_b4_dp4.json")
    assert {k: v for k, v in dp.items() if k not in ("ranks", "driver")} == {
        k: v for k, v in one.items() if k != "driver"}
    assert dp["ranks"] == 4 and dp["driver"] == "det_train_dp"
    work = harness.read_json(harness.ROOT / "workloads" / "det_fp32_b4_dp4.json")
    assert work["chips"] == dp["ranks"] and work["config"] == "grit_swinb_det"


def dp_cell(seed: int = 3, seconds: float = 0.3, trace: bool = False) -> harness.Cell:
    cell = tiny.det_cell(seed=seed, seconds=seconds, trace=trace)
    cell.name = "tiny_det_dp"
    cell.traffic = dict(copy.deepcopy(tiny.DET_TRAFFIC), driver="det_train_dp", ranks=4)
    cell.workload["chips"] = 4
    return cell


def test_ddp_names_draw_the_same_weights():
    from grit_tpu_torch.detection.detector import build_detection_model
    from gritbench import program
    from gritbench.traffic.det_train_dp import DDP_PREFIX
    from gritbench.weights import make_weights

    cfg = tiny.DET_CONFIG
    model, _ = build_detection_model(program.detection_config(cfg), None, device="cpu",
                                     seed=None)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    det = cfg["model"]["detector"]
    a = make_weights(shapes, 11, "cpu", det=det)
    b = make_weights([(DDP_PREFIX + n, s) for n, s in shapes], 11, "cpu", det=det)
    assert all(torch.equal(a[n], b[DDP_PREFIX + n]) for n in a)


def test_global_step_over_shares_is_the_step_over_their_union():
    """With dropout and drop-path off, the global step over two ranks'
    shares of a batch is the one-card step over the whole batch: the losses
    normalised by the global box count, the gradients summed."""
    from grit_tpu_torch.detection.detector import build_detection_model
    from gritbench import program
    from gritbench.reference import detection
    from gritbench.reference.nn import Arith
    from gritbench.traffic import det_train
    from gritbench.traffic.det_train_dp import TARGETS
    from gritbench.weights import make_weights

    cell = tiny.det_cell(seed=21)
    cell.config["model"]["swin"]["drop_path_rate"] = 0.0
    cell.config["model"]["detector"]["dropout"] = 0.0
    model, _ = build_detection_model(program.detection_config(cell.config), None,
                                     device="cpu", seed=None)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    w0 = make_weights(shapes, cell.seed, "cpu", det=cell.config["model"]["detector"])
    batches = [(b["images"], b["pad"], {k: b[k] for k in TARGETS})
               for b in det_train.pool(cell.traffic, cell.config, cell.seed, "cpu")[:2]]
    assert all(b[0].shape[0] == 2 for b in batches)
    one = detection.train_steps(Arith("fp32"), w0, batches, cell.config, 5, "cpu")
    split = [[(im[i:i + 1], pad[i:i + 1], {k: v[i:i + 1] for k, v in t.items()})
              for i in range(2)] for im, pad, t in batches]
    dp = detection.global_steps(Arith("fp32"), w0, split, cell.config, [5, 6], "cpu")
    assert dp["loss"] == pytest.approx(one["loss"], rel=1e-5)
    assert dp["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-5)
    for k in w0:
        torch.testing.assert_close(dp["params"][k], one["params"][k], rtol=1e-5, atol=1e-7)


def judge(cell, values):
    return harness.judge(values, cell.workload["limits"])[0]


def test_rehearsal_over_four_gloo_ranks():
    cell = dp_cell(seed=2 ** 31 + 7, trace=True)
    out = cell.driver.run(cell)
    assert judge(cell, out["values"]), out["values"]
    rec = out["record"]
    assert rec["window"]["units"] % cell.traffic["read_every"] == 0
    assert out["attempted"] == rec["window"]["units"] * 2 * 4
    assert out["setup_s"] > 0 and out["e2e"]["train_images_per_s"] > 0
    assert rec["stretch"]["units"] == 1 and rec["flops_per_unit"] > 0


@pytest.mark.parametrize("arm", ["control", "fault", "half_fault"])
def test_arms_in_the_programs_place_fail(arm):
    cell = dp_cell(seed=12)
    values = cell.driver.arms(cell, [arm])[arm]
    assert not judge(cell, values), values


#: faults planted in every rank's program before it starts (a
#: ``sitecustomize`` module on the ranks' path)
PLANTED = {
    # the optimizer's step leaves every parameter as it was
    "unchanged": """
        from grit_tpu_torch.engine import optim
        optim.Adam.step = lambda self, closure=None: None
    """,
    # each rank's criterion sees the first half of its batch, its mean over it
    # (the one-image probe of ``wrap_data_parallel`` keeps its image)
    "half": """
        import torch
        from grit_tpu_torch.detection import losses
        real = losses.SetCriterion.__call__
        def half(self, outputs, targets, assigns=None, num_boxes=None):
            b = max(1, targets["valid"].shape[0] // 2)
            def cut(o):
                return {k: (v[:b] if torch.is_tensor(v) else [cut(a) for a in v])
                        for k, v in o.items()}
            return real(self, cut(outputs), {k: v[:b] for k, v in targets.items()},
                        assigns, num_boxes)
        losses.SetCriterion.__call__ = half
    """,
    # DDP never all-reduces: each rank steps on its own share
    "no_exchange": """
        from torch import nn
        real = nn.parallel.DistributedDataParallel.__init__
        def init(self, *a, **k):
            real(self, *a, **k)
            self.require_backward_grad_sync = False
        nn.parallel.DistributedDataParallel.__init__ = init
    """,
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_fault_in_the_ranks_fails(fault, tmp_path, monkeypatch):
    from grit_tpu_torch.parallel import distributed

    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(PLANTED[fault]))
    real = distributed.run_ranks
    monkeypatch.setattr(distributed, "run_ranks",
                        lambda *a, **k: real(*a, **k, paths=(str(tmp_path),)))
    cell = dp_cell(seed=30)
    out = cell.driver.run(cell)
    assert not judge(cell, out["values"]), out["values"]
    if fault == "unchanged":
        assert out["values"]["change_leaf_gap"] == pytest.approx(1.0)


def test_too_few_cards_prints_no_result(capsys):
    from gritbench import run

    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("four cards are here")
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "det_fp32_b4_dp4", "--seed", "1", "--seconds", "1"])
    assert isinstance(exc.value.code, str)     # an error message, exit status 1
    assert capsys.readouterr().out == ""


def test_a_rank_that_loads_jax_stops_the_run(tmp_path, monkeypatch, capsys):
    """The window runs in the ranks: a banned module that a rank holds once
    it has run stops the run before any result is printed."""
    from grit_tpu_torch.parallel import distributed

    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n")
    real = distributed.run_ranks
    monkeypatch.setattr(distributed, "run_ranks",
                        lambda *a, **k: real(*a, **k, paths=(str(tmp_path),)))
    cell = dp_cell(seed=31)
    with pytest.raises(SystemExit) as exc:
        cell.driver.run(cell)
    assert "jax" in str(exc.value.code)
    assert capsys.readouterr().out == ""
