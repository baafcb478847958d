"""The language-model caption cell's files: the cell resolves, its
configuration keeps the published widths, the counts match a hand count, the
readers read what the driver records, and a tiny run on the CPU is correct
and catches the planted fault."""

from __future__ import annotations

import pytest

from gritbench import harness
from gritbench.counts import caption as caption_counts, kimi_lm
from gritbench.tests.tiny_lm import LM_TINY, lm_cell

CELL = "cap_kimivl_beam5_b128"
NEW_METRICS = ("lm_prefill_ms.caption", "mla_ms.caption", "moe_ms.caption",
               "lm_head_ms.caption", "expert_load_max.caption", "moe_roofline.caption")


def test_cell_resolves():
    cell = harness.load_cell(CELL, harness.benchmark())
    assert cell.traffic["driver"] == "caption_generate_lm"
    assert (harness.ROOT / "traffic" / "caption_generate_lm.py").exists()
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW_METRICS) <= names
    assert {"mfu.caption", "peak_mem_gib.caption", "beam_sort_ms.caption"} <= names
    assert {m["name"] for m in cell.end_to_end} == {"caption_images_per_s",
                                                     "caption_batch_p90_ms", "setup_s"}
    assert cell.config["reduced"] == []


def test_configuration_keeps_the_published_widths():
    """Every language-model key the port reads is in the file at its top
    level, equal to the port's Kimi-VL-A3B defaults (but the start's
    ``initializer_range``, which the published config lacks)."""
    from grit_tpu_torch.config import KIMI_VL_A3B

    cfg = harness.read_json(harness.ROOT / "configs" / "grit_kimivl_a3b_caption.json")
    for key in set(KIMI_VL_A3B) - {"initializer_range"}:
        assert cfg[key] == KIMI_VL_A3B[key], key
    for key in ("vision_tower", "projector", "token_layout", "bos_eos", "weights"):
        assert key in cfg["assumed"]


def test_parameters_by_hand():
    """The tiny preset counted by hand, and 15.96 B at the published widths."""
    d, v, h = 64, 97, 4
    mla = d * h * (32 + 16) + d * (32 + 16) + 32 + 32 * h * (32 + 32) + h * 32 * d + 2 * d
    dense = 3 * d * 128
    moe = 8 * 3 * d * 48 + 8 * d + 8 + 3 * d * 48
    assert kimi_lm.params(LM_TINY) == 2 * v * d + d + 3 * mla + dense + 2 * moe == 299696
    cfg = harness.read_json(harness.ROOT / "configs" / "grit_kimivl_a3b_caption.json")
    assert kimi_lm.params(cfg) == pytest.approx(15.96e9, rel=5e-4)


def test_batch_flops_by_parts():
    """A b128 batch: the prefill of 211 slots an image and 19 decode steps
    over 640 rows come to ~2.2e9 active parameters a row."""
    cfg = harness.read_json(harness.ROOT / "configs" / "grit_kimivl_a3b_caption.json")
    tr = harness.read_json(harness.ROOT / "traffic" / "caption_lm_b128.json")
    slots = 150 + caption_counts.level_tokens(cfg, (384, 640))[-1] + 1
    assert slots == tr["prefix_slots"] == 211
    total = kimi_lm.batch_flops(cfg, tr, 19)
    rows = 128 * slots + 19 * 640
    lm_part = total - caption_counts.vision_flops(cfg, 128, (384, 640))
    assert 2 * 2.0e9 * rows < lm_part < 2 * 2.8e9 * rows


def test_grouped_gemm_work_by_hand():
    dims = {"experts": 3, "hidden": 8, "width": 4}
    flops, nbytes = kimi_lm.grouped_gemm_work([2, 0, 3], dims, 2)
    assert flops == {"gate_up": 2.0 * 5 * 8 * 8, "down": 2.0 * 5 * 4 * 8}
    assert nbytes["gate_up"] == 2 * (2 * 8 * 8 + 5 * 8 + 5 * 8)
    assert nbytes["down"] == 2 * (2 * 8 * 4 + 5 * 4 + 5 * 8)


def _reader(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def test_readers_are_silent_on_a_parent_record():
    """A record of a program without the new spans and counters (as the
    parent's) reads nothing, and raises nothing."""
    rec = {"stretch": None, "dtype": "bfloat16", "window": {"seconds": 1.0, "units": 1}}
    for name in NEW_METRICS:
        assert _reader(name).read(rec) is None


def test_expert_load_max():
    rec = {"stretch": {"moe": {"loads": [[2, 2, 2, 2], [4, 0, 0, 4]]}}}
    assert _reader("expert_load_max.caption").read(rec) == pytest.approx(1.5)


def test_tiny_run_is_correct_and_catches_the_fault():
    cell = lm_cell()
    out = cell.driver.run(cell)
    correct, _ = harness.judge(out["values"], cell.workload["limits"])
    assert correct
    fault = cell.driver.fault(cell)
    limits = cell.workload["limits"]
    assert max(fault[k] / limits[k] for k in limits) > 100


def test_tiny_run_catches_a_router_without_its_bias():
    """Six experts chosen without the correction bias are the same number
    of experts, mostly near the k-th: the share of rows that chose
    otherwise than the reference fails."""
    cell = lm_cell()
    fault = cell.driver.fault_unbiased(cell)
    assert fault["route_flip_share"] > 10 * cell.workload["limits"]["route_flip_share"]
