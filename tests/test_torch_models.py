"""grit_tpu_torch models against the JAX package, on the CPU, at fp32.

One dims table builds a tiny JAX captioner (grit_tpu, XLA path:
``fused_attn=False``, ``msda_impl="flat"``) and its port twin
(grit_tpu_torch).  The port's seeded random weights cross to JAX through
``grit_tpu.convert.state_dict_to_params``; inputs are made with numpy from a
seed.  Swin depths (2, 2) with window 6 on a 64x96 bucket: the stage maps
16x24 and 8x12 pad to window multiples, the odd blocks shift, and the
second image's real size (40x72) is below the bucket, so the window pad
masks, shifted windows, image pad masks and MSDA's real_hw all run.

Tolerance: 2e-5 absolute on O(1) features (relative to their max for the
deep stacks), from f32 summation order and LN's variance formula (the port's
nn.LayerNorm takes two passes, flax E[x^2] - mu^2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.convert import state_dict_to_params, verify_against

VOCAB, D, MAXLEN = 50, 32, 12
PAD, BOS, EOS = 1, 2, 3
SWIN = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window=6, pos_dim=D)
DET = dict(d_model=D, n_heads=4, num_layers=2, dim_feedforward=64, num_levels=2,
           num_points=2, num_classes=10, num_queries=6)
BUCKET = (64, 96)
REAL_SIZES = [(64, 96), (40, 72)]
ATOL = 2e-5


# ---------------------------------------------------------------------------
# tiny twins (shared with test_torch_slice.py)
# ---------------------------------------------------------------------------

def torch_captioner(seed: int = 0):
    from grit_tpu_torch.models.cap_generator import CaptionGenerator
    from grit_tpu_torch.models.captioner import GRITCaptioner, init_weights
    from grit_tpu_torch.models.det_module import DetectionModule
    from grit_tpu_torch.models.detector import Detector
    from grit_tpu_torch.models.grid_net import GridFeatureNetwork
    from grit_tpu_torch.models.swin import SwinTransformer

    model = GRITCaptioner(
        Detector(SwinTransformer(**SWIN), DetectionModule(**DET), hidden_dim=D),
        GridFeatureNetwork(2, d_in=D, d_model=D, n_heads=4),
        CaptionGenerator(VOCAB, MAXLEN, 2, PAD, d_model=D, n_heads=4))
    init_weights(model, torch.Generator().manual_seed(seed))
    # the reference init zeroes the MSDA offset/weight projections and sets
    # every norm to the identity; perturb them so sampling locations and
    # weights depend on the query and the norms' affine parameters matter
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "sampling_offsets.weight" in name or "attention_weights.weight" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(torch.randn(mod.weight.shape, generator=g) * 0.3)
                mod.bias.add_(torch.randn(mod.bias.shape, generator=g) * 0.3)
    return model.eval()


def jax_captioner(dtype=None):
    """The JAX twin; ``dtype`` is its compute dtype (flax ``dtype=``)."""
    from grit_tpu.models.captioner import GRITCaptioner
    from grit_tpu.models.det_module import DetectionModule
    from grit_tpu.models.detector import Detector
    from grit_tpu.models.swin import SwinTransformer

    backbone = SwinTransformer(drop_path_rate=0.0, fused_attn=False, dtype=dtype, **SWIN)
    det = DetectionModule(msda_impl="flat", name="det_module", dtype=dtype, **DET)
    return GRITCaptioner(
        detector=Detector(backbone=backbone, det_module=det, hidden_dim=D, dtype=dtype),
        grid_feat_dim=D, d_model=D, n_heads=4, vocab_size=VOCAB, max_len=MAXLEN,
        pad_idx=PAD, bos_idx=BOS, eos_idx=EOS, grid_net_layers=2, cap_gen_layers=2,
        dtype=dtype)


def port_state(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def jax_params(model) -> dict:
    """The port model's weights as a grit_tpu params tree."""
    return state_dict_to_params(port_state(model))


def uint8_images(seed: int = 0):
    """-> (uint8 [B, H, W, 3], pad mask [B, H, W]) numpy, REAL_SIZES in BUCKET."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((len(REAL_SIZES), *BUCKET, 3), np.uint8)
    mask = np.ones((len(REAL_SIZES), *BUCKET), bool)
    for i, (h, w) in enumerate(REAL_SIZES):
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        mask[i, :h, :w] = False
    return imgs, mask


def assert_close(a, b, atol=ATOL, scale=False):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    tol = atol * max(1.0, np.abs(b).max()) if scale else atol
    err = np.abs(a - b).max()
    assert err <= tol, f"max abs err {err:.3e} > {tol:.3e}"


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """Run the port on one CPU thread.  torch's intra-op worker threads have
    been seen to return one thread's whole chunk of an erf off by ~1e-4 (in
    about 1 process in 50 on a virtualised x86 host, and in none of 600 with
    one thread), which would read here as a port mismatch."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    model = torch_captioner()
    return model, jax_captioner(), jax_params(model)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_swin_matches_jax(twins):
    from grit_tpu.models.swin import SwinTransformer

    model, _, params = twins
    x = np.random.default_rng(4).standard_normal((2, *BUCKET, 3)).astype(np.float32)
    jswin = SwinTransformer(drop_path_rate=0.0, fused_attn=False, **SWIN)
    ref = jax.jit(jswin.apply)({"params": params["detector"]["backbone"]}, x)
    with torch.no_grad():
        out = model.detector.backbone(torch.from_numpy(x))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert_close(o.numpy(), r, scale=True)


def test_det_module_matches_jax(twins):
    from grit_tpu.models.det_module import DetectionModule

    model, _, params = twins
    rng = np.random.default_rng(5)
    shapes = [(8, 12), (4, 6)]
    srcs = [rng.standard_normal((2, h, w, D)).astype(np.float32) for h, w in shapes]
    masks = []
    for h, w in shapes:   # image 1 real on 5/8 of the rows, 3/4 of the cols
        m = np.zeros((2, h, w), bool)
        m[1, h * 5 // 8:] = True
        m[1, :, w * 3 // 4:] = True
        masks.append(m)
    jdet = DetectionModule(msda_impl="flat", **DET)
    ref = jax.jit(jdet.apply)({"params": params["detector"]["det_module"]}, srcs, masks)
    with torch.no_grad():
        out = model.detector.det_module([torch.from_numpy(s) for s in srcs],
                                        [torch.from_numpy(m) for m in masks])
    for o, r in zip(out, ref):   # hs, init reference, per-layer references
        assert_close(o.numpy(), r, scale=True)


def test_detector_matches_jax(twins):
    from grit_tpu.utils.nested import ImageBatch as JaxBatch
    from grit_tpu_torch.utils.nested import ImageBatch

    model, jmodel, params = twins
    imgs, mask = uint8_images()
    ref = jax.jit(lambda p, b: jmodel.apply(p, b, method=lambda m, x: m.detector(x)))(
        {"params": params}, JaxBatch(jnp.asarray(imgs), jnp.asarray(mask)))
    with torch.no_grad():
        out = model.detector(ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)))
    assert set(out) == set(ref) == {"gri_feat", "gri_mask", "reg_feat", "reg_mask"}
    for k in out:
        assert_close(out[k].numpy(), ref[k], scale=True)


def test_grid_net_matches_jax(twins):
    from grit_tpu.models.grid_net import GridFeatureNetwork

    model, _, params = twins
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    mask = np.zeros((2, 1, 1, 24), bool)
    mask[1, ..., 15:] = True
    jnet = GridFeatureNetwork(n_layers=2, d_in=D, d_model=D, n_heads=4)
    ref, _ = jax.jit(jnet.apply)({"params": params["grid_net"]}, x, mask)
    with torch.no_grad():
        out, _ = model.grid_net(torch.from_numpy(x), torch.from_numpy(mask))
    assert_close(out.numpy(), ref, scale=True)


def _vis_inputs(seed=7):
    rng = np.random.default_rng(seed)
    gri_mask = np.zeros((2, 1, 1, 24), bool)
    gri_mask[1, ..., 18:] = True
    return {"gri_feat": rng.standard_normal((2, 24, D)).astype(np.float32),
            "gri_mask": gri_mask,
            "reg_feat": rng.standard_normal((2, 6, D)).astype(np.float32),
            "reg_mask": np.zeros((2, 1, 1, 6), bool)}


def test_cap_generator_teacher_forcing_matches_jax(twins):
    model, jmodel, params = twins
    vis = _vis_inputs()
    seq = np.random.default_rng(8).integers(4, VOCAB, (2, 7))
    seq[0, 0], seq[1, 0] = BOS, BOS
    seq[1, 5:] = PAD
    ref = jax.jit(lambda p, s, v: jmodel.apply(p, s, v, method=lambda m, s_, v_: m.cap_generator(s_, v_)))(
        {"params": params}, seq, vis)
    with torch.no_grad():
        out = model.cap_generator(torch.from_numpy(seq),
                                  {k: torch.from_numpy(v) for k, v in vis.items()})
    assert_close(out.numpy(), ref, scale=True)


@pytest.mark.parametrize("fold", [1, 2])
def test_cap_generator_decode_step_matches_teacher_forcing(twins, fold):
    """decode_step against the KV cache, one token at a time, reproduces the
    teacher-forced log-probs; with ``vis_fold`` the beams of an image share
    its per-image visual K/V."""
    model, _, _ = twins
    vis = {k: torch.from_numpy(v) for k, v in _vis_inputs().items()}
    seq = torch.from_numpy(np.random.default_rng(9).integers(4, VOCAB, (2 * fold, 6)))
    seq[:, 0] = BOS
    tiled = {k: v.repeat_interleave(fold, 0) for k, v in vis.items()}
    with torch.no_grad():
        ref = model.cap_generator(seq, tiled)
        kv = model.precompute_vis_kv(vis)
        cache = model.init_cache(2 * fold, seq.shape[1])
        for t in range(seq.shape[1]):
            logp, cache = model.decode_step(seq[:, t:t + 1], t, vis, cache,
                                            vis_kv=kv, vis_fold=fold)
            assert_close(logp.numpy(), ref[:, t].numpy(), atol=1e-5, scale=True)


def test_beam_search_matches_jax_with_ties():
    """Tie order: a log-prob table with many exact ties (two distinct rows,
    half-integer logits) and an EOS in the vocabulary; both beam searches
    must pick the same beams, sequences and scores."""
    from grit_tpu.decoding.beam_search import beam_search as jax_beam_search
    from grit_tpu_torch.decoding.beam_search import beam_search

    rng = np.random.default_rng(10)
    b, k, v, t_max, eos = 3, 3, 7, 6, 3
    rows = np.round(rng.standard_normal((t_max, 2, v)) * 2) / 2
    logits = rows[:, rng.integers(0, 2, v)]                      # [T, V_tok, V]
    logp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)

    def jstep(token, t, vis, cache):
        return jnp.asarray(logp)[t][token[:, 0]], cache

    def tstep(token, t, vis, cache):
        return torch.from_numpy(logp[t])[token[:, 0]], cache

    ref = jax_beam_search(jstep, {"c": jnp.zeros((b * k, 1))}, {}, b, k, t_max, 2, eos,
                          out_size=k, tile_vis=False)
    out = beam_search(tstep, {"c": torch.zeros(b * k, 1)}, {}, b, k, t_max, 2, eos,
                      out_size=k)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_array_equal(out.log_probs.numpy(), np.asarray(ref.log_probs))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_params_state_dict_round_trip(twins):
    from grit_tpu_torch.convert import params_to_state_dict

    model, _, params = twins
    sd = port_state(model)
    back = params_to_state_dict(params)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    fresh = torch_captioner(seed=3)
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()}, strict=True)


def test_compute_dtype_casts_only_linear_and_conv(twins):
    """to_compute_dtype(bf16) rounds the Linear/convolution weights and
    biases, as flax's Dense/Conv(dtype=bf16) do at every call; the norm
    parameters, the relative-position tables and the embeddings stay f32
    values, as flax reads them."""
    import copy
    import re

    from grit_tpu_torch.models.captioner import to_compute_dtype

    model, _, _ = twins
    bf = to_compute_dtype(copy.deepcopy(model), torch.bfloat16)
    f32 = re.compile(r"(norm\d?|layer_norm|input_proj\.\d+\.1)\.(weight|bias)$"
                     r"|relative_position_bias_table$|(query_embed|word_emb|pos_emb)\.weight$"
                     r"|level_embed$")
    orig = dict(model.named_parameters())
    n_f32 = 0
    for name, p in bf.named_parameters():
        if f32.search(name):
            n_f32 += 1
            assert p.dtype == torch.float32 and torch.equal(p, orig[name]), name
        else:
            assert p.dtype == torch.bfloat16 and torch.equal(p, orig[name].bfloat16()), name
    assert n_f32 > 40


def test_port_names_cover_jax_tree(twins):
    """verify_against(eval_shape(init)) is silent at the tiny size and at the
    full size of the shipped model (built on the meta device)."""
    from grit_tpu.config import default_caption_config
    from grit_tpu.models.captioner import build_captioner as jax_build
    from grit_tpu.utils.nested import ImageBatch as JaxBatch
    from grit_tpu_torch.models.captioner import build_captioner

    _, jmodel, params = twins
    imgs = JaxBatch(jnp.zeros((1, *BUCKET, 3)), jnp.zeros((1, *BUCKET), bool))
    seq = jnp.full((1, 4), BOS, jnp.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), imgs, seq))["params"]
    assert verify_against(shapes, params) == []

    config = default_caption_config()
    full = build_captioner(config, device="meta", seed=None)
    sd = {k: np.broadcast_to(np.zeros((), np.float32), v.shape)
          for k, v in full.state_dict().items()}
    imgs = JaxBatch(jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 128, 128), bool))
    full_shapes = jax.eval_shape(
        lambda: jax_build(config).init(jax.random.PRNGKey(0), imgs, seq))["params"]
    assert verify_against(full_shapes, state_dict_to_params(sd)) == []


def test_load_reference_checkpoint_strict(twins, tmp_path):
    """A reference-format .pth (state_dict key, plus the buffers and dead
    modules the reference carries) loads with strict=True."""
    from grit_tpu_torch.convert import load_reference_checkpoint

    model, _, _ = twins
    sd = dict(model.state_dict())
    sd["detector.backbone.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(36, 36)
    sd["detector.backbone.layers.0.downsample.expansion.weight"] = torch.zeros(4, 4)
    sd["cap_generator.layers.0.self_att.running_keys"] = torch.zeros(1)
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    fresh = torch_captioner(seed=5)
    fresh.load_state_dict(load_reference_checkpoint(str(path)), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
