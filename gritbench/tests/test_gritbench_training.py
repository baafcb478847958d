"""The detector pre-training cell at a tiny size on the CPU: the reference's
three steps against the port's (float32 on both sides, the same dropout and
drop-path masks), the control in the program's place failing, and whole
runs with the training step broken underneath coming out not correct."""

from __future__ import annotations

import pytest
import torch

from gritbench import harness, training
from gritbench.reference.nn import tf32_round
from gritbench.tests.tiny import det_cell


def run(cell):
    out = cell.driver.run(cell)
    return out, harness.judge(out["values"], cell.workload["limits"])[0]


def test_reference_agrees_with_the_port():
    out, correct = run(det_cell(seed=2 ** 31 + 3))
    assert correct, out["values"]
    assert out["attempted"] > 0 and out["e2e"]["train_images_per_s"] > 0


def test_control_fails():
    cell = det_cell(seed=4)
    correct, _ = harness.judge(cell.driver.control(cell), cell.workload["limits"])
    assert not correct


@pytest.mark.parametrize("which", ["det", "xe"])
def test_state_returned_unchanged(monkeypatch, which):
    """The optimizer's step leaves every parameter as it was."""
    from grit_tpu_torch.engine import optim
    from gritbench.tests import tiny

    monkeypatch.setattr(optim.Adam, "step", lambda self, closure=None: None)
    out, correct = run((tiny.det_cell if which == "det" else tiny.xe_cell)(seed=5))
    assert not correct and out["values"]["change_leaf_gap"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
    """The criterion sees the first half of the batch, its mean over it."""
    from grit_tpu_torch.detection import losses

    real = losses.SetCriterion.__call__

    def half(self, outputs, targets, assigns=None, num_boxes=None):
        b = targets["valid"].shape[0] // 2

        def cut(o):
            return {k: (v[:b] if torch.is_tensor(v) else [cut(a) for a in v])
                    for k, v in o.items()}
        return real(self, cut(outputs), {k: v[:b] for k, v in targets.items()}, assigns,
                    num_boxes)

    monkeypatch.setattr(losses.SetCriterion, "__call__", half)
    out, correct = run(det_cell(seed=6))
    assert not correct and out["values"]["loss_gap"] > 1e-2, out["values"]


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -12), 3.0])
    assert tf32_round(x).tolist() == [1.0, 1.0 + 2 ** -9, -1.0, 3.0]


def test_worst_leaf_gap_leaves_out_noise():
    ref = {"loss": [2.0] * 3, "grad_norm": [1.0] * 3,
           "first_grad": {"a": 1.0, "b": 2.0, "c": 1e-9}, "change": {"a": 1.0, "b": 1.0, "c": 0}}
    prog = {"loss": [2.0] * 3, "grad_norm": [1.0] * 3,
            "first_grad": {"a": 1.0, "b": 2.0, "c": 5.0}, "change": {"a": 1.0, "b": 0.5, "c": 9}}
    v = training.compare(prog, ref)
    assert v["grad_leaf_gap"] == 0.0 and v["change_leaf_gap"] == pytest.approx(0.5)


def test_xe_reference_agrees_with_the_port():
    from gritbench.tests.tiny import xe_cell

    out, correct = run(xe_cell(seed=2 ** 31 + 9))
    assert correct, out["values"]


def test_xe_control_fails():
    from gritbench.tests.tiny import xe_cell

    cell = xe_cell(seed=8)
    correct, _ = harness.judge(cell.driver.control(cell), cell.workload["limits"])
    assert not correct


def test_xe_half_the_batch_left_out(monkeypatch):
    """The XE loss takes the mean over the first half of the batch."""
    from grit_tpu_torch.engine import xe
    from gritbench.tests.tiny import xe_cell

    real = xe.nll_sum

    def half(log_probs, captions, pad_idx):
        b = captions.shape[0] // 2
        return real(log_probs[:b], captions[:b], pad_idx)

    monkeypatch.setattr(xe, "nll_sum", half)
    out, correct = run(xe_cell(seed=10))
    assert not correct and out["values"]["loss_gap"] > 1e-2, out["values"]


@pytest.mark.parametrize("which", ["det", "xe"])
def test_planted_half_batch_fault_fails(which):
    """The fault planted in the reference put in the program's place (as the
    control script reads it on the card) comes out not correct."""
    from gritbench.tests import tiny

    cell = (tiny.det_cell if which == "det" else tiny.xe_cell)(seed=14)
    values = cell.driver.fault(cell)
    assert not harness.judge(values, cell.workload["limits"])[0], values
