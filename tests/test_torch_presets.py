"""The port's other Swin presets (large, small, tiny, nano) against the JAX
package, on the CPU, at fp32.

The registry holds the same five presets as ``grit_tpu.models.swin``.  One
tiny twin per width family of the presets runs through both packages from
one numpy seed: C 64 (nano; heads (2, 4), window 7), C 96 (small, tiny;
heads (3, 6), window 7) and C 192 (large; heads (6, 12), window 12), each with
depths (2, 2) on a 64x96 image, whose stage maps 16x24 and 8x12 pad to window
multiples (21x28 and 14x14 at window 7, 24x24 and 12x12 at window 12) and
whose stage-2 map at window 12 is smaller than one window.  The port runs its
plain versions here (the kernels' CPU path).

Tolerances: the eval-mode forward within 2e-5 of each output's max (f32
summation order and LN's variance formula, as tests/test_torch_models.py);
gradients within 1e-5 of each leaf's max for one op (K4 + K5 at the
preset's window, K5's plain version against the Pallas ``_bwd_kernel`` in
interpret mode at window 7) and 1e-4 for a whole training forward and
backward of the twin ("a step": two stages of blocks, merges and LNs
compound the summation-order differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.models import swin as jswin
from grit_tpu.ops import window as jwin
from grit_tpu.ops import window_attention as jwa
from grit_tpu_torch import convert
from grit_tpu_torch.models import swin as tswin
from grit_tpu_torch.ops import window_attention as twa
from test_torch_models import assert_close, torch_one_thread  # noqa: F401
from test_torch_ops import _bf16, _f, _f32_bias, _t, interpret

PRESETS = ("swin_large_win7_384_22k", "swin_small", "swin_tiny", "swin_nano")
KEYS = ("embed_dim", "depths", "num_heads", "window", "drop_path_rate", "pos_dim")
# one tiny twin per width family: (embed_dim, heads, window, pos_dim)
FAMILIES = {"C64 window 7 (nano)": (64, (2, 4), 7, 96),
            "C96 window 7 (small, tiny)": (96, (3, 6), 7, 128),
            "C192 window 12 (large)": (192, (6, 12), 12, 160)}
IMAGE = (2, 64, 96, 3)


@pytest.mark.parametrize("name", sorted(jswin.BACKBONES))
def test_registry_matches_jax(name):
    """Every preset of the JAX registry, with the same widths, depths, heads,
    window, drop-path rate and last projection."""
    assert name in tswin.BACKBONES
    assert {k: tswin.BACKBONES[name][k] for k in KEYS} == {
        k: jswin.BACKBONES[name][k] for k in KEYS}
    assert set(tswin.BACKBONES) == set(jswin.BACKBONES)


def _twin(family: str, seed: int = 0):
    """(port SwinTransformer, JAX SwinTransformer, JAX params) of a family's
    twin: the port's seeded weights with every 1-D parameter (biases, norm
    affines) perturbed so that each one matters, crossed to JAX by the
    converter."""
    from grit_tpu_torch.models.captioner import init_weights

    c, heads, window, pos_dim = FAMILIES[family]
    kw = dict(embed_dim=c, depths=(2, 2), num_heads=heads, window=window, pos_dim=pos_dim)
    model = tswin.SwinTransformer(drop_path_rate=0.0, **kw)
    init_weights(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.2)
    sd = {f"detector.backbone.{k}": v.detach().numpy().copy()
          for k, v in model.state_dict().items()}
    params = convert.state_dict_to_params(sd)["detector"]["backbone"]
    return model, jswin.SwinTransformer(drop_path_rate=0.0, fused_attn=False, **kw), params


@pytest.mark.parametrize("family", list(FAMILIES))
def test_twin_forward_matches_jax(family):
    """eval(): every stage pads its map to window multiples once (the stage-2
    map at window 12 is smaller than one window) and runs K1 then K2 a block
    over the padded rows; outputs within 2e-5 of their max."""
    model, jmodel, params = _twin(family)
    x = np.random.default_rng(4).standard_normal(IMAGE).astype(np.float32)
    ref = jax.jit(jmodel.apply)({"params": params}, x)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert_close(o.numpy(), r, scale=True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_twin_training_gradients_match_jax(family):
    """train(): the gradient path (K4 + K5 on the zero-padded map, K2 on the
    unpadded rows, K10a, K10b), every parameter's gradient of sum(outputs x
    cotangents) against jax.grad of the same, 1e-4 of each leaf's max."""
    model, jmodel, params = _twin(family, seed=2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(IMAGE).astype(np.float32)
    shapes = [o.shape for o in jax.eval_shape(lambda: jmodel.apply({"params": params}, x))]
    cots = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def loss(p):
        outs = jmodel.apply({"params": p}, x, deterministic=False)
        return sum((o * c).sum() for o, c in zip(outs, cots))

    ref = convert.params_to_state_dict(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))
    model.train()
    outs = model(torch.from_numpy(x))
    sum((o * _t(c)).sum() for o, c in zip(outs, cots)).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref)
    for n, g in grads.items():
        r = ref[n]
        err = np.abs(g.numpy() - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= 1e-4, f"{n}: {err:.3e}"


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("shift", ["none", "half window"])
def test_block_attention_gradients_at_the_preset_window(family, shift):
    """K4 + K5 (``block_attention_train``) at a family's stage-1 width, heads
    and window, on a zero-padded map: all six gradients against jax.grad over
    ``_unfused``, 1e-5 of each gradient's max."""
    c, heads, win = FAMILIES[family][0], FAMILIES[family][1][0], FAMILIES[family][2]
    sh = win // 2 if shift == "half window" else 0
    b, hp, wp, real = 2, 2 * win, 3 * win, (2 * win - 3, 3 * win - 4)
    n = win * win
    f = _f(np.random.default_rng(20 + win))
    x = f(b, hp, wp, c)
    x[:, real[0]:] = 0
    x[:, :, real[1]:] = 0
    args = dict(x=x, qkv_w=f(3 * c, c, sc=c ** -0.5), qkv_b=f(3 * c, sc=0.1),
                proj_w=f(c, c, sc=c ** -0.5), proj_b=f(c, sc=0.1),
                table=f((2 * win - 1) ** 2, heads))
    cot = f(b, hp, wp, c)
    idx = jwin.relative_position_index((win, win)).reshape(-1)
    mask = jwin.shifted_window_mask(hp, wp, win, sh) if sh else None

    def jbranch(x, qkv_w, qkv_b, proj_w, proj_b, table):
        xs = jnp.roll(x, (-sh, -sh), (1, 2))
        xw = jwin.window_partition(xs, win).reshape(b, -1, n, c)
        qkv = xw @ qkv_w.T + qkv_b
        bias = table[idx].reshape(n, n, heads).transpose(2, 0, 1)[None]
        if mask is not None:
            bias = bias + jnp.asarray(mask)[:, None]
        o = jwa._unfused(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias,
                         (c // heads) ** -0.5, heads)
        y = jwin.window_reverse((o @ proj_w.T + proj_b).reshape(-1, n, c), win, hp, wp)
        return (jnp.roll(y, (sh, sh), (1, 2)) * cot).sum()

    names = list(args)
    ref = jax.grad(jbranch, argnums=tuple(range(6)))(*[args[k] for k in names])
    leaves = {k: _t(v).requires_grad_() for k, v in args.items()}
    out = twa.block_attention_train(*[leaves[k] for k in names], num_heads=heads, window=win,
                                    shift=sh)
    (out * _t(cot)).sum().backward()
    for k, r in zip(names, ref):
        r = np.asarray(r)
        err = np.abs(leaves[k].grad.numpy() - r).max() / np.abs(r).max()
        assert err <= 1e-5, f"{k}: {err:.3e}"


# window 7 (N = 49, odd): two windows by three, head dim 32 as every preset
W7_GEO = dict(b=2, hp=14, wp=21, heads=2, d=32, win=7)


@pytest.mark.parametrize("shift", [0, 3])
def test_window_attention_bwd_plain_f32_matches_jax_kernel_at_window_7(shift):
    """K5's plain version, which chip_smoke.py holds both Hopper backwards to
    at N = 49, against the Pallas ``_bwd_kernel`` in interpret mode
    (``_backward``), fed the table and the shift mask as a dense bias at scale
    1 (q pre-scaled by s = d^-1/2, so the port's dq is the body's times s):
    dq, dk, dv within 2e-5 of each one's max, dtable against the body's
    per-window bias gradient scattered into the table within 1e-5."""
    g = W7_GEO
    b, hp, wp, heads, d, win = g["b"], g["hp"], g["wp"], g["heads"], g["d"], g["win"]
    n, nw, c = win * win, (hp // win) * (wp // win), heads * d
    f = _f(np.random.default_rng(40 + shift))
    do = f(b, nw, n, c)
    qkv = f(b * nw * n, 3 * c)
    qkv[:, :c] *= d ** -0.5
    table = f((2 * win - 1) ** 2, heads)
    dqkv, dtable = twa.window_attention_bwd_plain(
        _t(qkv), _t(do.reshape(-1, c)), _t(table), batch=b, hp=hp, wp=wp, num_heads=heads,
        window=win, shift=shift)
    dqkv = dqkv.numpy().reshape(b, nw, n, 3 * c)
    q, k, v = (qkv[:, i * c:(i + 1) * c].reshape(b, nw, n, c) for i in range(3))
    with interpret(jwa):
        *refs, dbias = jwa._backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(_f32_bias(table, win, hp, wp, shift)), 1.0,
                                     heads, jnp.asarray(do))
    for i, (name, r, factor) in enumerate(zip(("dq", "dk", "dv"), refs, (d ** -0.5, 1.0, 1.0))):
        r = np.asarray(r) * factor
        np.testing.assert_allclose(dqkv[..., i * c:(i + 1) * c], r, atol=2e-5 * np.abs(r).max(),
                                   rtol=0, err_msg=name)
    idx = jwin.relative_position_index((win, win)).reshape(-1)
    ref_table = np.zeros_like(table)
    np.add.at(ref_table, idx, np.asarray(dbias).sum(0).reshape(heads, n * n).T)
    np.testing.assert_allclose(dtable.numpy(), ref_table, atol=1e-5 * np.abs(ref_table).max(),
                               rtol=0)


@pytest.mark.parametrize("shift", [0, 3])
def test_window_attention_bwd_plain_bf16_matches_jax_kernel_at_window_7(shift):
    """bf16 at N = 49: K5's plain version keeps the Pallas body's rounding
    points (P before dV, the score gradient times the scale before dQ and
    dK), as tests/test_torch_ops.py holds at window 6.  Head dim 16 makes
    the scale 0.25, a power of two, so both round alike: at most 1% of dq,
    dk, dv one bf16 ulp apart; dtable within 1e-5 of its max."""
    rng = np.random.default_rng(50 + shift)
    b, hp, wp, heads, d, win = 2, 14, 21, 2, 16, 7
    n, nw, c = win * win, (hp // win) * (wp // win), heads * d
    f = _f(rng)
    qkv = f(b * nw * n, 3 * c)
    qkv[:, :c] *= d ** -0.5
    table = f((2 * win - 1) ** 2, heads)
    (jqkv, tqkv), (jdo, tdo) = _bf16(qkv), _bf16(f(b * nw * n, c))
    dqkv, dtable = twa.window_attention_bwd_plain(tqkv, tdo, _t(table), batch=b, hp=hp, wp=wp,
                                                  num_heads=heads, window=win, shift=shift)
    dqkv = dqkv.float().numpy().reshape(b, nw, n, 3 * c)
    jq, jk, jv = (jqkv[:, i * c:(i + 1) * c].reshape(b, nw, n, c) for i in range(3))
    with interpret(jwa):
        *grads, dbias = jwa._backward(jq, jk, jv, jnp.asarray(_f32_bias(table, win, hp, wp, shift)),
                                      1.0, heads, jdo.reshape(b, nw, n, c))
    for i, (name, gr, factor) in enumerate(zip(("dq", "dk", "dv"), grads, (d ** -0.5, 1.0, 1.0))):
        ref = np.asarray(gr.astype(jnp.float32)) * factor
        out = dqkv[..., i * c:(i + 1) * c]
        ulp = 2.0 ** -7 * np.abs(ref).max()
        assert np.mean(out != ref) <= 0.01, name
        np.testing.assert_allclose(out, ref, atol=ulp, rtol=0, err_msg=name)
    idx = jwin.relative_position_index((win, win)).reshape(-1)
    ref_table = np.zeros_like(table)
    np.add.at(ref_table, idx, np.asarray(dbias).sum(0).reshape(heads, n * n).T)
    np.testing.assert_allclose(dtable.numpy(), ref_table, atol=1e-5 * np.abs(ref_table).max(),
                               rtol=0)


def _products(name: str) -> list[tuple[str, int, int]]:
    """(label, N, K) of every product of a preset's backbone: qkv, proj, fc1
    and fc2 of each stage's blocks and its PatchMerging reduction."""
    bb = tswin.BACKBONES[name]
    depths, c0 = bb["depths"], bb["embed_dim"]
    outs = [c0 * 2 ** i for i in range(1, len(depths))] + [bb["pos_dim"]]
    prods = []
    for i in range(len(depths)):
        c = c0 * 2 ** i
        prods += [(f"stage{i + 1} qkv", 3 * c, c), (f"stage{i + 1} proj", c, c),
                  (f"stage{i + 1} fc1", 4 * c, c), (f"stage{i + 1} fc2", c, 4 * c),
                  (f"stage{i + 1} merge", outs[i], 4 * c)]
    return prods


@pytest.mark.parametrize("name", PRESETS)
def test_gemm_guard_takes_every_preset_product(name):
    """Every product of the four presets is one the bf16 and fp32 GEMM
    kernels take (N and K tails), so none first meets the guard on the card;
    a product one column short of a whole bf16 lane is still refused."""
    prods = _products(name)
    assert len(prods) == 20
    for label, n_out, k_in in prods:
        for dtype in (torch.bfloat16, torch.float32):
            twa.check_gemm_shape(n_out, k_in, dtype, label)
        with pytest.raises(ValueError):
            twa.check_gemm_shape(n_out - 1, k_in, torch.bfloat16, label)


@pytest.mark.parametrize("name", PRESETS)
def test_caption_model_builds_on_each_preset(name):
    """``model.backbone=<preset> model.grid_feat_dim=<its pos_dim>``: the
    captioner builds (on the meta device, full width) with the grid net
    reading the backbone's last map."""
    from grit_tpu_torch.config import default_caption_config
    from grit_tpu_torch.models.captioner import build_captioner

    config = default_caption_config()
    config.model.backbone = name
    config.model.grid_feat_dim = tswin.BACKBONES[name]["pos_dim"]
    model = build_captioner(config, device="meta", seed=None)
    swin = model.detector.backbone
    assert swin.num_channels[-1] == config.model.grid_feat_dim
    assert swin.layers[0].window == tswin.BACKBONES[name]["window"]
    assert swin.embed_dim == tswin.BACKBONES[name]["embed_dim"]


def test_swin_tiny_detector_names_cover_the_jax_tree():
    """The detector pre-training model on ``swin_tiny`` (full width, built on
    the meta device) carries exactly the parameter names and shapes of the
    JAX package's detection model on the same preset (eval_shape of its
    init): the presets share Swin-B's parameter tree, and the converter needs
    no new names."""
    from grit_tpu.config import default_detection_config as jax_detection_config
    from grit_tpu.convert import verify_against
    from grit_tpu.detection.detector import build_detection_model as jax_build
    from grit_tpu.utils.nested import ImageBatch as JaxBatch
    from grit_tpu_torch.config import default_detection_config
    from grit_tpu_torch.detection.detector import build_detection_model

    config = default_detection_config()
    config.model.backbone = "swin_tiny"
    model, _ = build_detection_model(config, device="meta", seed=None)
    jconfig = jax_detection_config()
    jconfig.model.backbone = "swin_tiny"
    jmodel, _ = jax_build(jconfig)
    imgs = JaxBatch(jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 128, 128), bool))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), imgs, training=True))
    sd = model.state_dict()
    zeros = {k: np.broadcast_to(np.zeros((), np.float32), v.shape) for k, v in sd.items()}
    assert verify_against(shapes["params"], convert.state_dict_to_params(zeros)) == []
    assert sd["backbone.layers.0.blocks.0.attn.qkv.weight"].shape == (288, 96)
    assert sd["backbone.layers.0.blocks.0.attn.relative_position_bias_table"].shape == (169, 3)
