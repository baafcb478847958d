"""The reference against the port at a tiny preset on the CPU (both in
float32: they agree to rounding), the control (the reference in float8 in
the program's place) failing the comparison, and whole tiny runs with the
timed path broken underneath coming out not correct."""

from __future__ import annotations

import pytest
import torch

from gritbench import harness
from gritbench.tests.tiny import caption_cell

#: float32 on both sides: the port and the reference differ by summation
#: order alone, a few float32 ulps of the outputs' scale
AGREE = 1e-4


def run(cell):
    out = cell.driver.run(cell)
    return out, harness.judge(out["values"], cell.workload["limits"])[0]


def test_reference_agrees_with_the_port():
    out, correct = run(caption_cell(seed=2 ** 31 + 11))
    assert correct, out["values"]
    assert all(v <= AGREE for v in out["values"].values()), out["values"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_traced_run_is_correct_and_reads_no_device_metric():
    cell = caption_cell(seed=5, trace=True)
    cell.per_layer = harness.benchmark()["per_layer"]
    out, correct = run(cell)
    assert correct
    metrics = harness.read_metrics(cell, out["record"])
    # a CPU trace holds no device events: no device metric is read from it
    assert not {k for k in metrics if k.split(".")[0] in
                ("decode_ms", "vision_ms", "gemm_roofline", "idle_share",
                 "launches_per_batch")}


def test_control_fails():
    cell = caption_cell(seed=4)
    values = cell.driver.control(cell)
    correct, _ = harness.judge(values, cell.workload["limits"])
    assert not correct, values


def test_token_altered_where_produced(monkeypatch):
    from grit_tpu_torch.decoding import beam_search as bs
    from grit_tpu_torch.engine import evaluator

    real = bs.beam_search

    def altered(*a, **k):
        res = real(*a, **k)
        seq = res.sequences.clone()
        seq[:, :, 0] = (seq[:, :, 0] + 7) % 50
        return res._replace(sequences=seq)

    monkeypatch.setattr(evaluator, "beam_search", altered)
    out, correct = run(caption_cell(seed=6))
    assert not correct, out["values"]


def test_layer_returning_its_input(monkeypatch):
    """The grid network's layers return their state unchanged."""
    from grit_tpu_torch.models import grid_net

    monkeypatch.setattr(grid_net.TransformerLayer, "forward", lambda self, q, k, v, m=None: q)
    out, correct = run(caption_cell(seed=7))
    assert not correct and out["values"]["grid_net_err"] > 1e-2, out["values"]


@pytest.mark.parametrize("mode", ["fp32", "fp8"])
def test_fp8_operands(mode):
    from gritbench.reference.nn import Arith, fp8_round

    x = torch.randn(64, 64)
    y = Arith(mode)._q(x)
    if mode == "fp32":
        assert torch.equal(y, x)
    else:
        assert torch.equal(y, fp8_round(x)) and 1e-3 < float((y - x).abs().max()) < 0.5


@pytest.mark.parametrize("mode", ["fp8", "tf32"])
def test_rounded_products_and_their_gradients(mode):
    """Forward and backward products read rounded operands; every operand,
    a convolution's too, gets a gradient."""
    from gritbench.reference.nn import Arith, fp8_round, tf32_round

    rnd = fp8_round if mode == "fp8" else tf32_round
    A = Arith(mode)
    x = torch.randn(3, 5, 8, requires_grad=True)
    w = torch.randn(4, 8, requires_grad=True)
    y = A.linear(x, w)
    assert torch.allclose(y, rnd(x) @ rnd(w).t(), atol=1e-5)
    y.sum().backward()
    assert torch.allclose(w.grad, torch.ones(15, 4).t() @ rnd(x).reshape(15, 8), atol=1e-4)
    a = torch.randn(2, 3, 4, requires_grad=True)
    b = torch.randn(2, 4, 5, requires_grad=True)
    out = A.matmul(a, b)
    assert torch.allclose(out, rnd(a) @ rnd(b), atol=1e-5)
    out.sum().backward()
    assert a.grad is not None and b.grad is not None
    img = torch.randn(1, 3, 8, 8, requires_grad=True)
    k = torch.randn(4, 3, 2, 2, requires_grad=True)
    A.conv2d(img, k, stride=2).sum().backward()
    assert float(k.grad.abs().sum()) > 0
