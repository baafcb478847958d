"""A tiny language-model caption cell that runs on the CPU: the port's
``swin_test`` vision stack of ``tiny.py`` and a 3-layer DeepSeek-V3-style
language model (hidden 64, 4 heads, latent 32, rope 16, nope 32, v 32, 8
experts of which 2 a token, 1 shared, layer 0 dense, vocabulary 97)."""

from __future__ import annotations

import copy

from gritbench import harness
from gritbench.tests.tiny import CAPTION_CONFIG, DET, SWIN

LM_TINY = {
    "vocab_size": 97, "hidden_size": 64, "intermediate_size": 128, "moe_intermediate_size": 48,
    "num_hidden_layers": 3, "num_attention_heads": 4, "n_shared_experts": 1,
    "n_routed_experts": 8, "routed_scaling_factor": 2.446, "kv_lora_rank": 32,
    "q_lora_rank": None, "qk_rope_head_dim": 16, "v_head_dim": 32, "qk_nope_head_dim": 32,
    "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "num_experts_per_tok": 2,
    "moe_layer_freq": 1, "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "rms_norm_eps": 1e-5, "rope_theta": 800000,
    "rope_scaling": None, "attention_bias": False, "tie_word_embeddings": False,
}

LM_CONFIG = {
    "dtype": "float32",
    **LM_TINY,
    "model": {"swin": SWIN, "detector": DET, "grid_feat_dim": 64, "grid_layers": 2,
              "d_model": 32, "n_heads": 4, "d_ff": 2048, "pad_idx": 1, "bos_idx": 95,
              "eos_idx": 96, "dropout": 0.2, "frozen_stages": 2, "decoder_name": "mla_moe"},
    "port_overrides": [o for o in CAPTION_CONFIG["port_overrides"]
                       if not o.startswith(("model.vocab_size", "model.max_len",
                                            "model.cap_generator"))]
    + ["model.cap_generator.decoder_name=mla_moe", "model.bos_idx=95", "model.eos_idx=96"],
}

LM_TRAFFIC = {"driver": "caption_generate_lm", "batch": 2, "bucket": [64, 96],
              "image_sizes": [[64, 96], [48, 64]], "prefix_slots": 31, "pool_batches": 2,
              "warmup_batches": 1, "beam_size": 3, "beam_len": 5, "trace_batches": 1,
              "sample_batches": 2, "sample_images": 2, "control_batches": 2,
              "route_tie": 0.01}


def lm_cell(seed: int = 3, seconds: float = 0.3, trace: bool = False) -> harness.Cell:
    # float32 on both sides: they differ by summation order alone
    work = {"config": "tiny_lm", "traffic": "tiny_lm", "chips": 1,
            "limits": {"vis_token_err": 1e-4, "latent_err": 1e-4, "logprob_gap": 1e-4,
                       "caption_gap": 1e-4, "route_flip_share": 0.05}}
    return harness.Cell("tiny_lm_caption", work, copy.deepcopy(LM_CONFIG),
                        copy.deepcopy(LM_TRAFFIC), seed=seed, seconds=seconds, trace=trace,
                        device="cpu")
