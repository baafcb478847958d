"""The yardstick's counts by hand: one Swin-B block at 384x640, the GEMM
launches of a caption batch, and the roofline of one launch."""

from __future__ import annotations

import pytest

from gritbench import harness, peaks
from gritbench.counts import caption, swin

CFG = harness.read_json(harness.ROOT / "configs" / "grit_swinb_caption.json")
SW = CFG["model"]["swin"]


def test_stage_maps():
    assert swin.stage_maps(SW, (384, 640)) == [(96, 160), (48, 80), (24, 40), (12, 20)]


def test_one_block_by_hand():
    """Stage 1 of one image: 96x160 tokens of 128 channels, padded to
    96x168 for windows of 12."""
    g = swin.gemms(SW, 1, (384, 640))
    pad, c = 96 * 168, 128
    assert g[0] == {"m": pad, "n": 3 * c, "k": c, "bias": True, "resid": False}
    assert g[1] == {"m": pad, "n": c, "k": c, "bias": True, "resid": True}
    assert g[2] == {"m": pad, "n": 4 * c, "k": c, "bias": True, "resid": False}
    assert g[3] == {"m": pad, "n": c, "k": 4 * c, "bias": True, "resid": True}
    block = 2 * pad * c * 4 * c + 2 * 2 * pad * 144 * c + 2 * 96 * 160 * 8 * c * c
    embed = 2 * 96 * 160 * 128 * 48
    merges_and_rest = swin.model_flops(SW, 1, (384, 640)) - embed
    assert merges_and_rest > 2 * block


def test_caption_gemm_launches():
    tr = harness.read_json(harness.ROOT / "traffic" / "caption_b128.json")
    g = caption.gemm_launches(CFG, tr)
    assert len(g) == 4 * sum(SW["depths"]) + len(SW["depths"]) == 100
    assert g[-1] == {"m": 128 * 6 * 10, "n": 1024, "k": 4 * 1024, "bias": False,
                     "resid": False}


def test_least_time():
    g = {"m": 4096, "n": 4096, "k": 4096, "bias": False, "resid": False}
    t = swin.gemm_least_s(g, 2, peaks.FLOPS["bfloat16"], peaks.HBM_BYTES_PER_S)
    assert t == pytest.approx(2 * 4096 ** 3 / 989e12)
    thin = {"m": 1 << 20, "n": 8, "k": 8, "bias": False, "resid": False}
    t = swin.gemm_least_s(thin, 2, peaks.FLOPS["bfloat16"], peaks.HBM_BYTES_PER_S)
    assert t == pytest.approx(((1 << 20) * 16 + 64) * 2 / 3.35e12)


def test_batch_flops_scale():
    tr = harness.read_json(harness.ROOT / "traffic" / "caption_b128.json")
    f = caption.batch_flops(CFG, tr, 20)
    # about 160 GFLOP an image, most of it the backbone
    assert 100e9 < f / 128 < 250e9
    assert caption.vision_flops(CFG, 128, (384, 640)) > 0.8 * f
