"""The sequential and concat caption decoders, greedy and all-probs search and
the ensemble generator of grit_tpu_torch against the JAX package, on the CPU
at fp32.

Tiny twins as in test_torch_models.py (its dims), one for each decoder: the
port's seeded random weights (norms perturbed) cross to JAX through
``grit_tpu.convert.state_dict_to_params``.  The visual inputs are cached
detector features made with numpy from a seed (the freezing mode's path:
``compute_vis`` on a dict runs the grid network only), so the detector,
which test_torch_models.py holds, stays out of the way.

Tolerances: log-probs within 2e-5 of their max (f32 summation order and LN's
variance formula); one XE step's gradients within 1e-4 of each leaf's max, as
test_torch_train.py; beam, greedy and ensemble tokens exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.convert import state_dict_to_params
from test_torch_models import (BOS, D, DET, EOS, MAXLEN, PAD, SWIN, VOCAB, assert_close,
                               torch_one_thread)  # noqa: F401

DECODERS = ("sequential", "concat")
BEAM, STEPS = 3, 8


def port_twin(decoder: str, seed: int = 0):
    from grit_tpu_torch.models.cap_generator import CaptionGenerator
    from grit_tpu_torch.models.captioner import GRITCaptioner, init_weights
    from grit_tpu_torch.models.det_module import DetectionModule
    from grit_tpu_torch.models.detector import Detector
    from grit_tpu_torch.models.grid_net import GridFeatureNetwork
    from grit_tpu_torch.models.swin import SwinTransformer

    model = GRITCaptioner(
        Detector(SwinTransformer(**SWIN), DetectionModule(**DET), hidden_dim=D),
        GridFeatureNetwork(2, d_in=D, d_model=D, n_heads=4),
        CaptionGenerator(VOCAB, MAXLEN, 2, PAD, d_model=D, n_heads=4, decoder_name=decoder))
    init_weights(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():   # norms away from the identity, so their parameters matter
        for mod in model.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.add_(torch.randn(mod.weight.shape, generator=g) * 0.3)
                mod.bias.add_(torch.randn(mod.bias.shape, generator=g) * 0.3)
    return model.eval()


def jax_twin(decoder: str, dropout: float = 0.1):
    from grit_tpu.models.captioner import GRITCaptioner
    from grit_tpu.models.det_module import DetectionModule
    from grit_tpu.models.detector import Detector
    from grit_tpu.models.swin import SwinTransformer

    backbone = SwinTransformer(drop_path_rate=0.0, fused_attn=False, **SWIN)
    det = DetectionModule(msda_impl="flat", name="det_module", **DET)
    return GRITCaptioner(
        detector=Detector(backbone=backbone, det_module=det, hidden_dim=D),
        grid_feat_dim=D, d_model=D, n_heads=4, vocab_size=VOCAB, max_len=MAXLEN,
        pad_idx=PAD, bos_idx=BOS, eos_idx=EOS, grid_net_layers=2, cap_gen_layers=2,
        decoder_name=decoder, dropout=dropout)


def jax_params(model) -> dict:
    return {"params": state_dict_to_params(
        {k: v.detach().numpy().copy() for k, v in model.state_dict().items()})}


@pytest.fixture(scope="module", params=("parallel",) + DECODERS)
def twins(request):
    model = port_twin(request.param)
    return request.param, model, jax_twin(request.param), jax_params(model)


def cached_features(seed: int = 7, batch: int = 2, dtype=np.float32) -> dict:
    """Detector features as the hdf5 holds them: image 1's grid half padded."""
    rng = np.random.default_rng(seed)
    gri_mask = np.zeros((batch, 1, 1, 24), bool)
    gri_mask[1::2, ..., 18:] = True
    return {"gri_feat": rng.standard_normal((batch, 24, D)).astype(dtype),
            "gri_mask": gri_mask,
            "reg_feat": rng.standard_normal((batch, 6, D)).astype(dtype),
            "reg_mask": np.zeros((batch, 1, 1, 6), bool)}


def _captions(seed=8, batch=2, length=7):
    seq = np.random.default_rng(seed).integers(4, VOCAB, (batch, length))
    seq[:, 0] = BOS
    seq[1, 5:] = PAD
    return seq


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decoder", DECODERS)
def test_teacher_forcing_matches_jax(decoder):
    model = port_twin(decoder)
    jmodel, params = jax_twin(decoder), jax_params(model)
    feats, seq = cached_features(), _captions()
    ref = jax.jit(lambda p, f, s: jmodel.apply(p, f, s))(params, feats, seq)
    with torch.no_grad():
        out = model(feats, torch.from_numpy(seq))
    assert_close(out.numpy(), ref, scale=True)


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("fold", [1, 2])
def test_decode_step_matches_teacher_forcing(decoder, fold):
    """One token at a time against the KV caches, the visual inputs per image
    (``vis_fold``) and projected at every step: the teacher-forced log-probs."""
    model = port_twin(decoder)
    seq = torch.from_numpy(np.random.default_rng(9).integers(4, VOCAB, (2 * fold, 6)))
    seq[:, 0] = BOS
    with torch.no_grad():
        vis = model.compute_vis(cached_features())
        assert model.precompute_vis_kv(vis) is None
        ref = model.cap_generator(seq, {k: v.repeat_interleave(fold, 0) for k, v in vis.items()})
        cache = model.init_cache(2 * fold, seq.shape[1])
        for t in range(seq.shape[1]):
            logp, cache = model.decode_step(seq[:, t:t + 1], t, vis, cache, vis_fold=fold)
            assert_close(logp.numpy(), ref[:, t].numpy(), atol=1e-5, scale=True)


@pytest.mark.parametrize("decoder", DECODERS)
def test_decode_never_takes_the_fused_tail(decoder, monkeypatch):
    """K11 serves the parallel layer only: a sequential or concat decode step
    never reaches it, even where the parallel layer would take it."""
    from grit_tpu_torch.models import cap_generator as tcap
    from grit_tpu_torch.ops import decode_layer as tdl

    model = port_twin(decoder)

    def refuse(*a, **kw):
        raise AssertionError("the fused decode tail was called")

    monkeypatch.setattr(tcap, "use_fused_tail", lambda layer, x: True)
    monkeypatch.setattr(tdl, "fused_decode_layer_tail", refuse)
    with torch.no_grad():
        vis = model.compute_vis(cached_features())
        model.decode_step(torch.full((2, 1), BOS), 0, vis, model.init_cache(2, 4))


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("eos", [EOS, VOCAB])
def test_beam_sequences_match_jax(decoder, eos):
    """Beam 3 through each package's make_caption_generator: the same tokens.
    ``VOCAB``: EOS is no vocabulary id, so every beam runs all steps."""
    from grit_tpu.engine.evaluator import make_caption_generator as jax_generator
    from grit_tpu_torch.engine.evaluator import make_caption_generator

    model = port_twin(decoder)
    jmodel, params = jax_twin(decoder), jax_params(model)
    feats = cached_features()
    kw = dict(beam_size=BEAM, max_len=STEPS, bos_idx=BOS, eos_idx=eos)
    out = make_caption_generator(model, **kw)(feats, 2).numpy()
    ref = np.asarray(jax_generator(jmodel, **kw)(params, feats, 2))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("decoder", DECODERS)
def test_xe_step_matches_jax(decoder):
    """One XE step on cached features (the freezing mode's batch), dropouts
    at 0: the loss within 1e-5 relative, every gradient leaf within 1e-4 of
    the leaf's max (plus 1e-7 absolute), every updated parameter within 1e-4
    of its max where the gradient is above 1e-6 (twice the learning rate
    elsewhere), as test_torch_train.py::test_xe_step_matches_jax."""
    from grit_tpu.engine import optim as joptim
    from grit_tpu.engine import xe as jxe
    from grit_tpu_torch import convert
    from grit_tpu_torch.engine import optim as toptim
    from grit_tpu_torch.engine import xe as txe
    from test_torch_train import BACKBONE_LR, SCHED

    model = port_twin(decoder).train()
    for mod in model.modules():
        if hasattr(mod, "p"):
            mod.p = 0.0
    params = jax_params(model)
    jmodel = jax_twin(decoder, dropout=0.0)
    feats, caps = cached_features(), _captions(length=9)
    tx, labels = joptim.build_optimizer(params)
    jstep = jxe.make_xe_train_step(jmodel, tx, labels, pad_idx=PAD, sched_cfg=SCHED,
                                   backbone_lr=BACKBONE_LR, donate=False)

    def jloss(p):
        out = jmodel.apply(p, feats, caps, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jxe.nll_loss(out, caps, PAD)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    jstate = jxe.TrainState.create(params, tx).epoch_tick()
    jstate, jmetrics = jax.block_until_ready(
        jstep(jstate, {"samples": feats, "captions": jnp.asarray(caps)}, jax.random.PRNGKey(0)))

    opt = toptim.build_optimizer(model, model_lr=SCHED["init_lr"], backbone_lr=BACKBONE_LR)
    state = txe.TrainState(model, opt, global_steps=1, generator=None)
    state, metrics = txe.make_xe_train_step(pad_idx=PAD, sched_cfg=SCHED)(
        state, {"samples": feats, "captions": torch.from_numpy(caps)})

    assert abs(float(metrics["loss"]) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref_g = convert.params_to_state_dict(jax.tree.map(np.asarray, ref_grads["params"]))
    ref_p = convert.params_to_state_dict(jax.tree.map(np.asarray, jstate.params["params"]))
    n_grads = 0
    for name, p in model.named_parameters():
        if p.grad is None:   # the detector: cached features bypass it
            assert name.startswith("detector.") and not ref_g[name].any(), name
            continue
        n_grads += 1
        err = np.abs(p.grad.numpy() - ref_g[name]).max()
        assert err <= 1e-4 * np.abs(ref_g[name]).max() + 1e-7, name
        big = np.abs(ref_g[name]) > 1e-6
        err = np.abs(p.detach().numpy() - ref_p[name])
        assert (err <= np.where(big, 1e-4 * np.abs(ref_p[name]).max(),
                                2 * metrics["lr"])).all(), name
    assert n_grads == sum(1 for n, _ in model.named_parameters() if not n.startswith("detector."))


def test_xe_step_on_float16_features_computes_in_the_model_dtype():
    """The hdf5 stores float16: ``compute_vis`` casts cached features to the
    compute dtype (f32 here), so the step equals the one on the same values
    in f32."""
    from grit_tpu_torch.engine import xe as txe

    model = port_twin("sequential")
    f16 = cached_features(dtype=np.float16)
    f32 = {k: v.astype(np.float32) if v.dtype == np.float16 else v for k, v in f16.items()}
    step = txe.make_eval_loss_step(model, pad_idx=PAD)
    caps = torch.from_numpy(_captions())
    assert float(step({"samples": f16, "captions": caps})) == float(
        step({"samples": f32, "captions": caps}))
    with torch.no_grad():
        assert model.compute_vis(f16)["reg_feat"].dtype == torch.float32


# ---------------------------------------------------------------------------
# greedy, all-probs beam, ensemble (every decoder)
# ---------------------------------------------------------------------------

def _jax_decode_fn(jmodel, params, fold):
    def step(token, t, vis, cache):
        return jmodel.apply(params, token, t, vis["feat"], cache, method="decode_step",
                            vis_kv=vis["kv"], vis_fold=fold)
    return step


def _port_decode_fn(model, fold):
    def step(token, t, vis, cache):
        return model.decode_step(token, t, vis["feat"], cache, vis_kv=vis["kv"], vis_fold=fold)
    return step


def _port_vis(model, feats):
    vis = model.compute_vis(feats)
    return {"feat": vis, "kv": model.precompute_vis_kv(vis)}


def test_greedy_search_matches_jax(twins):
    from grit_tpu.decoding.beam_search import greedy_search as jax_greedy
    from grit_tpu_torch.decoding.beam_search import greedy_search

    _, model, jmodel, params = twins
    feats = cached_features()

    @jax.jit
    def jrun(p, f):
        vis = jmodel.apply(p, f, method="compute_vis")
        vis = {"feat": vis, "kv": jmodel.apply(p, vis, method="precompute_vis_kv")}
        cache = jmodel.apply(p, 2, STEPS, method="init_cache")
        return jax_greedy(_jax_decode_fn(jmodel, p, 1), cache, vis, 2, STEPS, BOS, EOS)

    ref_seq, ref_lp = jrun(params, feats)
    with torch.no_grad():
        seq, lp = greedy_search(_port_decode_fn(model, 1), model.init_cache(2, STEPS),
                                _port_vis(model, feats), 2, STEPS, BOS, EOS)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref_seq))
    assert_close(lp.numpy(), ref_lp)


def test_all_probs_match_jax(twins):
    """``return_all_probs``: [B, out, T, V] within 2e-5 of JAX's, with the
    early exit off; the sequences equal the default beam's.  EOS is the
    greedy first token of image 0, so beams freeze and the default beam may
    stop early."""
    from grit_tpu.decoding.beam_search import beam_search as jax_beam
    from grit_tpu_torch.decoding.beam_search import beam_search, greedy_search

    _, model, jmodel, params = twins
    feats = cached_features()
    out_size = 2
    with torch.no_grad():
        vis = _port_vis(model, feats)
        eos = int(greedy_search(_port_decode_fn(model, 1), model.init_cache(2, 1), vis, 2, 1,
                                BOS, VOCAB)[0][0, 0])

    @jax.jit
    def jrun(p, f):
        vis = jmodel.apply(p, f, method="compute_vis")
        vis = {"feat": vis, "kv": jmodel.apply(p, vis, method="precompute_vis_kv")}
        cache = jmodel.apply(p, 2 * BEAM, STEPS, method="init_cache")
        return jax_beam(_jax_decode_fn(jmodel, p, BEAM), cache, vis, 2, BEAM, STEPS, BOS, eos,
                        out_size=out_size, return_all_probs=True, tile_vis=False)

    ref = jrun(params, feats)
    with torch.no_grad():
        def run(**kw):
            return beam_search(_port_decode_fn(model, BEAM), model.init_cache(2 * BEAM, STEPS),
                               vis, 2, BEAM, STEPS, BOS, eos, out_size=out_size, **kw)

        res, plain = run(return_all_probs=True), run()
    assert res.all_log_probs.shape == (2, out_size, STEPS, VOCAB)
    assert_close(res.all_log_probs.numpy(), ref.all_log_probs, scale=True)
    np.testing.assert_array_equal(res.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_array_equal(res.sequences.numpy(), plain.sequences.numpy())
    assert plain.all_log_probs is None
    assert (res.sequences.numpy() == eos).any()


def test_one_member_ensemble_equals_the_caption_generator(twins):
    from grit_tpu_torch.engine.evaluator import make_caption_generator
    from grit_tpu_torch.models.ensemble import make_ensemble_generator

    _, model, _, _ = twins
    feats = cached_features()
    kw = dict(beam_size=BEAM, max_len=STEPS, bos_idx=BOS, eos_idx=EOS)
    res = make_ensemble_generator([model], **kw)(feats, 2)
    np.testing.assert_array_equal(res.sequences[:, 0].numpy(),
                                  make_caption_generator(model, **kw)(feats, 2).numpy())


def test_two_member_ensemble_matches_jax(twins):
    from grit_tpu.models.ensemble import make_ensemble_generator as jax_ensemble
    from grit_tpu_torch.models.ensemble import make_ensemble_generator

    decoder, model, jmodel, params = twins
    other = port_twin(decoder, seed=1)
    feats = cached_features()
    kw = dict(beam_size=BEAM, max_len=STEPS, bos_idx=BOS, eos_idx=EOS, out_size=2)
    res = make_ensemble_generator([model, other], **kw)(feats, 2)
    # device arrays: the generator closes over its members' parameters
    members = [jax.tree.map(jnp.asarray, p) for p in (params, jax_params(other))]
    ref = jax_ensemble(jmodel, members, **kw)(feats, 2)
    np.testing.assert_array_equal(res.sequences.numpy(), np.asarray(ref.sequences))
    assert_close(res.scores.numpy(), ref.scores, scale=True)


# ---------------------------------------------------------------------------
# build_captioner and the converter
# ---------------------------------------------------------------------------

def _tiny_config(**model):
    from grit_tpu_torch.config import default_caption_config

    overrides = ["model.backbone=swin_test", "model.grid_feat_dim=64", "model.d_model=32",
                 "model.n_heads=4", "model.grid_net.n_layers=1",
                 "model.cap_generator.n_layers=1", "model.detector.d_model=32",
                 "model.detector.dim_feedforward=64", "model.detector.num_heads=4",
                 "model.detector.num_layers=1", "model.detector.num_levels=2",
                 "model.detector.num_points=2", "model.detector.num_queries=6",
                 "model.detector.num_classes=10", "model.vocab_size=20"]
    return default_caption_config().apply_overrides(
        overrides + [f"model.{k}={v}" for k, v in model.items()])


@pytest.mark.parametrize("decoder", DECODERS)
def test_build_captioner_builds_the_decoder(decoder):
    from grit_tpu_torch.models.cap_generator import GENERATOR_LAYER
    from grit_tpu_torch.models.captioner import build_captioner

    config = _tiny_config(**{"cap_generator.decoder_name": decoder})
    model = build_captioner(config, device="cpu")
    assert model.cap_generator.decoder_name == decoder
    assert all(type(layer) is GENERATOR_LAYER[decoder] for layer in model.cap_generator.layers)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_captioner(config)


@pytest.mark.parametrize("flag", ["use_gri_feat", "use_reg_feat"])
def test_build_captioner_refuses_a_single_feature(flag):
    """grit_tpu's captioner fails with a KeyError without either feature
    (its CaptionGenerator._vis reads both), so the port refuses to build one."""
    from grit_tpu_torch.models.captioner import build_captioner

    with pytest.raises(NotImplementedError, match="JAX package has no working captioner"):
        build_captioner(_tiny_config(**{flag: "false"}), device="cpu")


@pytest.mark.parametrize("decoder", DECODERS)
def test_converter_round_trips_the_new_layers(decoder):
    """Port state_dict -> flax tree: the JAX package's own converter's tree,
    with the names and shapes of the JAX generator's init; and back, exactly."""
    from grit_tpu.convert import verify_against
    from grit_tpu.models.cap_generator import CaptionGenerator as JaxGenerator
    from grit_tpu_torch import convert

    model = port_twin(decoder)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = convert.state_dict_to_params(sd)
    ref = state_dict_to_params(sd)
    flat, flat_ref = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (tree, ref))
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat, flat_ref):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    layer = tree["cap_generator"]["layers_0"]
    assert set(layer) == ({"self_att", "vis_att", "pwff"} if decoder == "concat"
                          else {"self_att", "vis_att1", "vis_att2", "pwff"})
    jgen = JaxGenerator(vocab_size=VOCAB, max_len=MAXLEN, n_layers=2, pad_idx=PAD, d_model=D,
                        n_heads=4, decoder_name=decoder)
    init = jgen.init(jax.random.PRNGKey(0), jnp.full((1, 3), BOS),
                     {k: v[:1] for k, v in cached_features().items()})
    assert verify_against(init["params"], tree["cap_generator"]) == []
    back = convert.params_to_state_dict(tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


# ---------------------------------------------------------------------------
# the decode step replayed from graphs (decoding/step_graphs.py)
# ---------------------------------------------------------------------------

class ReplayedGraphs:
    """Stand-in for ``step_graphs.CudaGraphs`` on the CPU: a capture runs the
    step once and keeps it, a replay reruns it on the set's buffers and, as a
    graph's replay, moves no launch counter."""

    device_type = "cpu"

    def __init__(self):
        self.warm_ups = self.captures = self.replays = 0

    def warm_up(self, fn, device):
        self.warm_ups += 1
        fn()

    def capture(self, fn, device):
        from grit_tpu_torch.ops import decode_layer as tdl

        self.captures += 1
        fn()
        owner = self

        class Graph:
            def replay(self):
                owner.replays += 1
                counts = dict(tdl.LAUNCHES)
                fn()
                tdl.LAUNCHES.update(counts)

        return Graph()


@pytest.fixture
def counted_tail(monkeypatch):
    """K11 on the CPU (its plain version), counted as the card's launches are."""
    from grit_tpu_torch.models import cap_generator as tcap
    from grit_tpu_torch.ops import decode_layer as tdl

    plain = tdl.fused_decode_layer_tail

    def counted(*a, **kw):
        tdl.LAUNCHES["decode_tail"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(tcap, "use_fused_tail", lambda layer, x: True)
    monkeypatch.setattr(tdl, "fused_decode_layer_tail", counted)
    return tdl.LAUNCHES


def _graphed_twin(seed: int = 0):
    from grit_tpu_torch.decoding.step_graphs import StepGraphs

    model = port_twin("parallel", seed)
    model.cap_generator.step_graphs = StepGraphs(ReplayedGraphs())
    return model


def _search(model, feats):
    """Beam 3 x STEPS, every beam running all steps (EOS no vocabulary id)."""
    from grit_tpu_torch.decoding.beam_search import beam_search

    with torch.inference_mode():
        return beam_search(_port_decode_fn(model, BEAM), model.init_cache(2 * BEAM, STEPS),
                           _port_vis(model, feats), 2, BEAM, STEPS, BOS, VOCAB, out_size=BEAM,
                           return_margins=True)


def _assert_same_result(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("condition", ["cpu", "dropout", "grad", "tp"])
def test_decode_step_bypasses_the_graphs(condition, monkeypatch):
    """Where the step cannot be captured (CPU tensors under the card's graphs,
    a live dropout, grad on, a tensor-parallel layer) ``decode_step`` is the
    eager step, bit for bit, and captures nothing."""
    from grit_tpu_torch.decoding.step_graphs import StepGraphs
    from grit_tpu_torch.models import attention

    model = port_twin("parallel")
    gen = model.cap_generator
    graphs = ReplayedGraphs()
    if condition != "cpu":
        gen.step_graphs = StepGraphs(graphs)
    if condition == "dropout":
        model.train()
    if condition == "tp":
        gen.layers[0].pwff.tp_group = object()
        monkeypatch.setattr(attention, "copy_to_tp", lambda x, group: x)
        monkeypatch.setattr(attention, "reduce_from_tp", lambda x, group: x.float())
        monkeypatch.setattr(attention, "tp_rank", lambda group: 0)
        monkeypatch.setattr(attention, "tp_size", lambda group: 1)
    context = torch.enable_grad if condition == "grad" else torch.no_grad

    def run(step):
        model.set_generator(torch.Generator().manual_seed(3))
        with context():
            vis = model.compute_vis(cached_features())
            kv = model.precompute_vis_kv(vis)
            cache = model.init_cache(2 * BEAM, 4)
            outs = []
            for t in range(3):
                token = torch.full((2 * BEAM, 1), BOS + t)
                logp, cache = step(token, t, vis, cache, vis_kv=kv, vis_fold=BEAM)
                outs.append(logp.detach().clone())
            return outs, cache

    outs, cache = run(gen.decode_step)
    ref, ref_cache = run(gen.decode_step_eager)
    assert all(torch.equal(a, b) for a, b in zip(outs, ref))
    assert torch.equal(cache["pad_hist"], ref_cache["pad_hist"])
    assert all(torch.equal(a, b) for kv, rkv in zip(cache["layers"], ref_cache["layers"])
               for a, b in zip(kv, rkv))
    assert (graphs.warm_ups, graphs.captures, graphs.replays) == (0, 0, 0)
    assert not gen.step_graphs.sets


def test_graphed_searches_equal_eager(counted_tail):
    """Two searches with other visual inputs through the capture and replay
    bookkeeping: each result equal to the eager step's; one capture a step,
    made in the first search (whose steps are their warm-ups), replays in the
    second; the visual inputs copied in at step 0."""
    graphed, eager = _graphed_twin(), port_twin("parallel")
    graphs = graphed.cap_generator.step_graphs.graphs
    for seed in (7, 11):
        feats = cached_features(seed)
        _assert_same_result(_search(graphed, feats), _search(eager, feats))
    assert (graphs.warm_ups, graphs.captures, graphs.replays) == (STEPS, STEPS, STEPS)
    assert len(graphed.cap_generator.step_graphs.sets) == 1


def test_kept_beam_result_survives_a_later_search(counted_tail):
    """No tensor of a BeamResult is a graph buffer: a later search leaves a
    kept result as it was."""
    model = _graphed_twin()
    kept = _search(model, cached_features(7))
    copy = type(kept)(*[None if x is None else x.clone() for x in kept])
    later = _search(model, cached_features(11))
    assert not torch.equal(later.scores, kept.scores)
    _assert_same_result(kept, copy)


def test_replayed_launch_counts_equal_eager(counted_tail):
    """A replay adds the launches its capture counted, and a capture's
    counts are taken back: the capturing search and a search of replays each
    count what the eager search counts (K11 once a layer a step)."""
    graphed, eager = _graphed_twin(), port_twin("parallel")
    layers = len(eager.cap_generator.layers)
    feats = cached_features()

    def launches(model):
        before = counted_tail["decode_tail"]
        _search(model, feats)
        return counted_tail["decode_tail"] - before

    assert launches(eager) == layers * STEPS
    assert launches(graphed) == layers * STEPS
    assert launches(graphed) == layers * STEPS
    assert graphed.cap_generator.step_graphs.graphs.replays == STEPS
