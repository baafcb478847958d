"""A tiny caption cell that runs on the CPU: the port's ``swin_test``
backbone and small widths, for the CPU tests of the harness."""

from __future__ import annotations

import copy

from gritbench import harness

SWIN = {"embed_dim": 16, "depths": [1, 1], "num_heads": [2, 2], "window": 4,
        "patch_size": 4, "pos_dim": 64, "drop_path_rate": 0.0}
DET = {"d_model": 32, "num_heads": 4, "num_layers": 2, "num_levels": 2, "num_points": 2,
       "num_queries": 6, "num_classes": 10, "dim_feedforward": 64, "dropout": 0.1}

CAPTION_CONFIG = {
    "dtype": "float32",
    "model": {"swin": SWIN, "detector": DET, "grid_feat_dim": 64, "grid_layers": 2,
              "decoder_layers": 2, "d_model": 32, "n_heads": 4, "d_ff": 2048, "vocab_size": 50,
              "max_len": 12, "pad_idx": 1, "bos_idx": 2, "eos_idx": 3, "beam_size": 3,
              "beam_len": 6, "dropout": 0.2, "frozen_stages": 2, "replicate_alpha_bug": True,
              "decoder_name": "parallel"},
    "port_overrides": [
        "model.backbone=swin_test", "model.grid_feat_dim=64", "model.d_model=32",
        "model.n_heads=4", "model.detector.d_model=32", "model.detector.num_heads=4",
        "model.detector.num_layers=2", "model.detector.num_levels=2",
        "model.detector.num_points=2", "model.detector.num_queries=6",
        "model.detector.num_classes=10", "model.detector.dim_feedforward=64",
        "model.vocab_size=50", "model.max_len=12", "model.grid_net.n_layers=2",
        "model.cap_generator.n_layers=2"],
}

CAPTION_TRAFFIC = {"driver": "caption_generate", "batch": 4, "bucket": [64, 96],
                   "image_sizes": [[64, 96], [48, 64]], "pool_batches": 2, "warmup_batches": 1,
                   "beam_size": 3, "beam_len": 6, "trace_batches": 1, "sample_batches": 2,
                   "sample_images": 2}


def caption_cell(seed: int = 3, seconds: float = 0.5, trace: bool = False,
                 limits: dict | None = None) -> harness.Cell:
    work = {"config": "tiny", "traffic": "tiny", "chips": 1,
            "limits": limits or {"swin_grid_err": 1e-4, "grid_net_err": 1e-4,
                                 "region_l1_err": 1e-4, "region_err": 1e-4, "logprob_gap": 1e-4,
                                 "caption_gap": 1e-4}}
    return harness.Cell("tiny_caption", work, copy.deepcopy(CAPTION_CONFIG),
                        copy.deepcopy(CAPTION_TRAFFIC), seed=seed, seconds=seconds,
                        trace=trace, device="cpu")


#: the port's ``swin_tiny`` preset: windows of 7 pad its maps, and its blocks
#: draw drop-path masks
SWIN_TINY = {"embed_dim": 96, "depths": [2, 2, 6, 2], "num_heads": [3, 6, 12, 24], "window": 7,
             "patch_size": 4, "pos_dim": 768, "drop_path_rate": 0.2}

DET_CONFIG = {
    "dtype": "float32",
    "model": {"swin": SWIN_TINY, "detector": dict(DET, num_levels=4), "frozen_stages": -1},
    "loss_weights": {"ce": 2.0, "bbox": 5.0, "giou": 2.0},
    "match_cost": {"class": 2.0, "bbox": 5.0, "giou": 2.0},
    "optimizer": {"lr": 1e-5, "lr_backbone": 2e-5, "weight_decay": 1e-4, "beta1": 0.9,
                  "beta2": 0.999, "eps": 1e-8, "clip_max_norm": 0.1},
    "port_overrides": [
        "model.backbone=swin_tiny", "model.detector.d_model=32", "model.d_model=32",
        "model.detector.num_heads=4", "model.detector.num_layers=2",
        "model.detector.num_levels=4", "model.detector.num_points=2",
        "model.detector.num_queries=6", "model.detector.num_classes=10",
        "model.num_classes=10", "model.detector.dim_feedforward=64", "optimizer.lr=1e-05",
        "optimizer.lr_backbone=2e-05", "optimizer.clip_max_norm=0.1"],
}

DET_TRAFFIC = {"driver": "det_train", "batch": 2, "bucket": [128, 192],
               "image_sizes": [[128, 192], [96, 160]], "boxes": [2, 5], "max_boxes": 6,
               "box_center": [0.15, 0.85], "box_size": [0.05, 0.3], "pool_batches": 4,
               "read_every": 2, "trace_steps": 1}


def det_cell(seed: int = 3, seconds: float = 0.3, trace: bool = False) -> harness.Cell:
    work = {"config": "tiny", "traffic": "tiny", "chips": 1,
            # float32 on both sides: they differ by summation order alone
            "limits": {"loss_gap": 1e-5, "grad_norm_gap": 1e-5, "grad_leaf_gap": 1e-4,
                       "change_leaf_gap": 1e-3}}
    return harness.Cell("tiny_det", work, copy.deepcopy(DET_CONFIG), copy.deepcopy(DET_TRAFFIC),
                        seed=seed, seconds=seconds, trace=trace, device="cpu")


XE_CONFIG = copy.deepcopy(CAPTION_CONFIG)
XE_CONFIG["dtype"] = "float32"
XE_CONFIG["model"].update(swin=SWIN_TINY, grid_feat_dim=768, frozen_stages=2,
                          detector=dict(DET, num_levels=4))
XE_CONFIG["port_overrides"] = [o for o in XE_CONFIG["port_overrides"]
                               if not o.startswith(("model.backbone", "model.grid_feat_dim",
                                                    "model.detector.num_levels"))] + [
    "model.backbone=swin_tiny", "model.grid_feat_dim=768", "model.detector.num_levels=4",
    "model.frozen_stages=2"]
XE_CONFIG["optimizer"] = {"schedule": {"num_epochs": 10, "num_its_per_epoch": 1000,
                                       "init_lr": 1e-4, "min_lr": 1e-4,
                                       "warmup_init_lr": 1e-5},
                          "backbone_lr": 1e-5, "beta1": 0.9, "beta2": 0.99, "eps": 1e-8,
                          "first_step": 1}

XE_TRAFFIC = {"driver": "xe_train", "batch": 2, "bucket": [64, 96],
              "image_sizes": [[64, 96], [48, 64]], "caption_tokens": [3, 6],
              "pool_batches": 4, "read_every": 2, "trace_steps": 1}


def xe_cell(seed: int = 3, seconds: float = 0.3, trace: bool = False) -> harness.Cell:
    work = {"config": "tiny", "traffic": "tiny", "chips": 1,
            "limits": {"loss_gap": 1e-4, "grad_leaf_gap": 0.05, "change_leaf_gap": 0.05}}
    return harness.Cell("tiny_xe", work, copy.deepcopy(XE_CONFIG), copy.deepcopy(XE_TRAFFIC),
                        seed=seed, seconds=seconds, trace=trace, device="cpu")
