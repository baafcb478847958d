"""The port's tensor-parallel layout (``grit_tpu_torch.parallel.mesh`` and
``parallel.tensor``: grit_tpu's ``model`` axis) on the CPU.

(a) ``tp_plan`` splits what ``grit_tpu.parallel.mesh.param_shardings`` splits
on a (4, 2) mesh of the 8 virtual CPU devices, over the dry run's tiny JAX
captioner (vocab 128: the head splits) and over the default config's shapes
(vocab 10201: the head stays whole), names crossed through ``convert``;
(b) two ranks' partials summed and finished equal the whole computation in
fp32 (1e-6 of its max), for K11's plain split, K2's shard path and
``FeedForward``; (c) ``dryrun_multichip(4, "cpu")`` in dp4 and dp2tp2;
(d) a dp2tp2 XE step over 4 gloo ranks against grit_tpu's one-device step on
the same converted weights (``test_torch_parallel``'s tolerances), and the
ranks' beam captions of the initial weights against grit_tpu's, token for
token; (e) ``gather_tp_state`` after ``shard_model`` gives the original state
bit for bit.

The ranks of (d) and (e) start once (``tp`` fixture) in fresh processes over
``tp_rank_body`` below: this module imports JAX and the JAX-side helpers only
inside its tests, so the ranks stay free of it.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from grit_tpu_torch.parallel.distributed import rank, run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD, DP, TP = 4, 2, 2
DEADLINE = 300.0
ROWS, BEAM, STEPS = 2, 3, 6
PLAIN_TOL = 1e-6


@pytest.fixture(scope="module")
def one_thread():
    """The port on one CPU thread in this process, as ``test_torch_models``'
    ``torch_one_thread`` (the ranks run one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the ranks' body (no JAX)
# ---------------------------------------------------------------------------

def tp_rank_body(model, batch, *, sched, backbone_lr, frozen_stages, pad, bos, eos) -> dict:
    """One rank of dp2tp2: the state gathered back after ``shard_model``;
    beam captions of the initial weights on this data rank's rows; one XE
    step on them -> the whole parameters and gradients (gathered), the loss."""
    from grit_tpu_torch.engine import optim
    from grit_tpu_torch.engine.scst import make_generate_step
    from grit_tpu_torch.engine.xe import TrainState, make_xe_train_step, xe_probe
    from grit_tpu_torch.parallel.mesh import (gather_tp_state, global_sum, make_groups,
                                              shard_batch, shard_model, split_params,
                                              tie_replicated_grads, tp_plan, wrap_data_parallel)
    from grit_tpu_torch.parallel.tensor import tp_size

    dp_group, tp_group = make_groups(DP, TP)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    plan = tp_plan(model, TP)
    shard_model(model, plan, tp_group)
    back = {k: v.clone() for k, v in gather_tp_state(model).items()}
    dp_rank = rank() // TP
    mine = shard_batch(batch, dp_rank, DP, int_fill=pad, int_first=bos)
    rows = int(mine["captions"].shape[0])
    seqs = make_generate_step(model, beam_size=BEAM, max_len=STEPS, bos_idx=bos,
                              eos_idx=eos)(mine["samples"], rows)[0]
    freeze = optim.frozen_mask(model, optim.swin_frozen_stages_predicate(frozen_stages))
    opt = optim.build_optimizer(model, model_lr=sched["init_lr"], backbone_lr=backbone_lr,
                                freeze=freeze)
    trained = [p for g in opt.param_groups for p in g["params"]]
    tie_replicated_grads(opt, model, tp_group)
    ddp = wrap_data_parallel(model, "cpu", trained=trained, probe=xe_probe([mine], pad_idx=pad),
                             group=dp_group)
    state = TrainState(ddp, opt, global_steps=1, generator=torch.Generator().manual_seed(dp_rank))
    state, metrics = make_xe_train_step(pad_idx=pad, sched_cfg=sched)(state, mine)
    split = split_params(model)
    grads = {}
    for name, p in model.named_parameters():
        g = None if p.grad is None else p.grad.detach().contiguous()
        if g is not None and name in split:
            parts = [torch.empty_like(g) for _ in range(tp_size(tp_group))]
            torch.distributed.all_gather(parts, g, group=tp_group)
            g = torch.cat(parts, split[name])
        grads[name] = g
    whole = gather_tp_state(model)
    return {"plan": plan, "split": sorted(split), "restored": {k: back[k] for k in before},
            "before": before, "sequences": seqs, "dp_rank": dp_rank,
            "tp_rank": rank() % TP, "loss": float(global_sum(metrics["loss"])),
            "lr": metrics["lr"],
            "ddp": type(ddp).__name__,
            "params": {k: whole[k].detach() for k, _ in model.named_parameters()},
            "own": {k: p.detach().clone() for k, p in model.named_parameters()},
            "grads": grads}


@pytest.fixture(scope="module")
def tp():
    """The four ranks of (d) and (e), started once."""
    from test_torch_parallel import xe_inputs
    from test_torch_models import BOS, EOS, PAD
    from test_torch_train import BACKBONE_LR, FROZEN_STAGES, SCHED, torch_train_captioner
    from grit_tpu_torch.utils.nested import ImageBatch

    imgs, mask, caps = xe_inputs(ROWS)
    batch = {"samples": ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)),
             "captions": torch.from_numpy(caps)}
    return run_ranks("test_torch_tensor_parallel:tp_rank_body", WORLD,
                     args=(torch_train_captioner(), batch),
                     kwargs=dict(sched=SCHED, backbone_lr=BACKBONE_LR,
                                 frozen_stages=FROZEN_STAGES, pad=PAD, bos=BOS, eos=EOS),
                     paths=[HERE], deadline=DEADLINE)


# ---------------------------------------------------------------------------
# (a) the plan against grit_tpu's param_shardings
# ---------------------------------------------------------------------------

def _jax_dims(params, shardings) -> dict:
    """{flax leaf index: the torch dim grit_tpu splits} from a params tree and
    its NamedSharding tree (columns of a kernel -> torch dim 0, rows -> 1)."""
    import jax

    out = {}
    for i, s in enumerate(jax.tree_util.tree_leaves(shardings)):
        spec = tuple(s.spec)
        if "model" in spec:
            out[i] = {(None, "model"): 0, ("model", None): 1}[spec]
    return out


def test_tp_plan_equals_param_shardings_on_the_dry_runs_captioner():
    """The dry run's tiny JAX captioner (``__graft_entry__.py``: vocab 128,
    d_ff 64 x 4 layers, Swin MLPs): its parameter tree by ``jax.eval_shape``,
    each leaf named by ``convert.params_to_state_dict``; ``tp_plan`` on those
    names and torch shapes is grit_tpu's layout, the vocab head split."""
    import jax
    import jax.numpy as jnp

    from grit_tpu.models.captioner import GRITCaptioner
    from grit_tpu.models.det_module import DetectionModule
    from grit_tpu.models.detector import Detector
    from grit_tpu.models.swin import SwinTransformer
    from grit_tpu.parallel.mesh import make_mesh, param_shardings
    from grit_tpu.utils.nested import ImageBatch
    from grit_tpu_torch import convert
    from grit_tpu_torch.parallel.mesh import tp_plan

    backbone = SwinTransformer(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window=4,
                               drop_path_rate=0.0, pos_dim=64)
    det = DetectionModule(d_model=64, n_heads=4, num_layers=2, dim_feedforward=128,
                          num_levels=2, num_points=2, num_classes=16, num_queries=10,
                          name="det_module")
    model = GRITCaptioner(detector=Detector(backbone=backbone, det_module=det, hidden_dim=64),
                          grid_feat_dim=64, d_model=64, n_heads=4, vocab_size=128, max_len=16,
                          grid_net_layers=2, cap_gen_layers=2, dropout=0.1)
    images = ImageBatch(jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 64, 64), bool))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), images,
                            jnp.full((2, 8), 2, jnp.int32))
    mesh = make_mesh(n_data=4, n_model=2)
    want_idx = _jax_dims(params, param_shardings(params, mesh))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    marked = []
    for i, leaf in enumerate(leaves):    # each leaf's index in its first element
        arr = np.zeros(leaf.shape, np.int64)
        arr.flat[0] = i
        marked.append(arr)
    state = convert.params_to_state_dict(jax.tree_util.tree_unflatten(treedef, marked)["params"])
    index = {name: int(v.flat[0]) for name, v in state.items()}
    want = {name: want_idx[i] for name, i in index.items() if i in want_idx}
    got = tp_plan({name: v.shape for name, v in state.items()}, 2)
    assert got == want
    assert got["cap_generator.fc.weight"] == 0 and len(got) == 2 * (2 + 2 + 2) + 1
    assert tp_plan({name: v.shape for name, v in state.items()}, 1) == {}


def test_tp_plan_equals_param_shardings_at_the_default_config():
    """The default caption config's shapes (the port's model on the meta
    device; each name crossed to its flax path by
    ``convert.state_dict_to_params``): grit_tpu's rules split the 60 FFN and
    MLP matrices and keep the odd vocab head (10201) whole, and so does
    ``tp_plan``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from grit_tpu.parallel.mesh import make_mesh, param_shardings
    from grit_tpu_torch import convert
    from grit_tpu_torch.config import default_caption_config
    from grit_tpu_torch.models.captioner import build_captioner
    from grit_tpu_torch.parallel.mesh import tp_plan

    model = build_captioner(default_caption_config(), device="meta", seed=None)
    tree: dict = {}
    where = {}
    for name, p in model.named_parameters():
        node = convert.state_dict_to_params({name: np.broadcast_to(np.zeros((), bool), p.shape)})
        path = []
        while isinstance(node, dict):
            (key, node), = node.items()
            path.append(key)
        leaf = tree
        for key in path[:-1]:
            leaf = leaf.setdefault(key, {})
        leaf[path[-1]] = jax.ShapeDtypeStruct(node.shape, np.float32)
        where[name] = tuple(path)
    specs = param_shardings(tree, make_mesh(n_data=4, n_model=2))

    def spec_at(path):
        node = specs
        for key in path:
            node = node[key]
        return tuple(node.spec)

    want = {}
    for name, path in where.items():
        spec = spec_at(path)
        if spec != tuple(P()):
            want[name] = {(None, "model"): 0, ("model", None): 1}[spec]
    got = tp_plan(model, 2)
    assert got == want and len(got) == 60
    assert "cap_generator.fc.weight" not in got and model.cap_generator.fc.weight.shape[0] == 10201


# ---------------------------------------------------------------------------
# (b) two shards' partials against the whole computation
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    return float((a - b).detach().abs().max() / b.detach().abs().max())


def test_k11_split_plain_sums_to_the_whole_tail():
    """K11's partial plain version on each half of d_ff (fc1's columns and
    bias, fc2's rows), the partials summed and finished, against
    ``decode_layer_tail_plain`` on the whole weights: 1e-6 of its max in fp32;
    both halves give the same enc bit for bit.  Through
    ``fused_decode_layer_tail_tp`` with no group, the whole weights give the
    whole tail bit for bit."""
    from grit_tpu_torch.ops import decode_layer as dl
    from test_torch_scst import tail_inputs

    x, kv, masks, pad, weights, kw = tail_inputs(True, seed=61, d=32, d_ff=64)
    kw["eps"] = 1e-5
    t = torch.from_numpy
    b = kv[0].shape[0]
    madd = [dl.additive_mask(t(m), b, m.shape[-1], "cpu") for m in masks]
    args = (t(x[:, 0]), t(kv[0]), t(kv[1]), madd[0], t(kv[2]), t(kv[3]), madd[1],
            t(pad).reshape(-1, 1))
    w = [t(np.ascontiguousarray(a)) for a in weights]
    whole = dl.decode_layer_tail_plain(*args, w, **kw)
    parts, encs = [], []
    for i in range(2):
        ws = list(w)
        ws[18], ws[19] = w[18].chunk(2, 1)[i], w[19].chunk(2)[i]
        ws[20] = w[20].chunk(2, 0)[i]
        part, enc = dl.decode_layer_tail_partial_plain(*args, ws, **kw)
        parts.append(part)
        encs.append(enc)
    assert torch.equal(encs[0], encs[1])
    got = dl.decode_layer_tail_finish_plain(parts[0] + parts[1], encs[0], *w[21:], args[-1],
                                            eps=1e-5, dtype=whole.dtype)
    assert _rel(got, whole) <= PLAIN_TOL
    mask_t = [t(m) for m in masks]
    tp_none = dl.fused_decode_layer_tail_tp(
        t(x), t(kv[0]), t(kv[1]), mask_t[0], t(kv[2]), t(kv[3]), mask_t[1], t(pad), w,
        group=None, **kw)
    assert torch.equal(tp_none[:, 0], whole)


@pytest.mark.parametrize("residual", [True, False])
def test_k2_shard_path_sums_to_mlp_plain(residual):
    """K2 on each half of the hidden units with fc2's bias left out
    (``mlp(..., fc2_b=None, residual=False)``), summed in f32 and finished by
    ``SwinBlock.mlp_finish``, against ``mlp_plain`` on the whole block: 1e-6
    of its max in fp32."""
    from grit_tpu_torch.models.swin import SwinBlock
    from grit_tpu_torch.ops import window_attention as wa

    g = torch.Generator().manual_seed(5)
    block = SwinBlock(32, 2, 4, 0)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3 + (p.dim() == 1) * 0.1)
    rows = torch.randn(37, 32, generator=g)
    m, n = block.mlp, block.norm2
    whole = wa.mlp_plain(rows, n.weight, n.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight,
                         m.fc2.bias, residual=residual)
    total = 0.0
    for i in range(2):
        total = total + wa.mlp(rows, n.weight, n.bias, m.fc1.weight.chunk(2, 0)[i],
                               m.fc1.bias.chunk(2)[i], m.fc2.weight.chunk(2, 1)[i], None,
                               residual=False).float()
    with torch.no_grad():
        got = block.mlp_finish(rows, total, residual)
    assert _rel(got, whole) <= PLAIN_TOL


def test_dropout_on_a_slice_draws_the_whole_mask():
    """``Dropout(x_i, shard=(i, n))`` on the i-th of n slices of the last dim,
    from a generator in the same state, drops exactly the i-th slice of what
    the whole tensor's draw drops: the ranks of a tensor group draw what one
    process draws, and their generators stay in step."""
    from grit_tpu_torch.models.layers import Dropout

    drop = Dropout(0.3)
    x = torch.randn(4, 5, 12)
    drop.generator = torch.Generator().manual_seed(11)
    whole = drop(x)
    for i, piece in enumerate(x.chunk(3, -1)):
        drop.generator = torch.Generator().manual_seed(11)
        assert torch.equal(drop(piece, shard=(i, 3)), whole.chunk(3, -1)[i])
    assert torch.equal(drop.eval()(x, shard=(0, 3)), x)


def test_feedforward_partials_sum_to_the_whole():
    """``FeedForward.partial`` on each half of d_ff, summed and through
    ``finish``, against the whole module's forward: 1e-6 of its max in fp32,
    and the gradients of x through both paths alike."""
    from grit_tpu_torch.models.attention import FeedForward

    torch.manual_seed(7)
    whole = FeedForward(32, 64, dropout=0.0)
    halves = [FeedForward(32, 32, dropout=0.0) for _ in range(2)]
    with torch.no_grad():
        for i, h in enumerate(halves):
            h.load_state_dict({**whole.state_dict(),
                               "fc1.weight": whole.fc1.weight.chunk(2, 0)[i],
                               "fc1.bias": whole.fc1.bias.chunk(2)[i],
                               "fc2.weight": whole.fc2.weight.chunk(2, 1)[i]})
    x = torch.randn(3, 5, 32, requires_grad=True)
    cot = torch.randn(3, 5, 32)
    want = whole(x)
    (gx_want,) = torch.autograd.grad((want * cot).sum(), x)
    got = halves[0].finish(x, halves[0].partial(x).float() + halves[1].partial(x).float())
    (gx,) = torch.autograd.grad((got * cot).sum(), x)
    assert _rel(got, want) <= PLAIN_TOL and _rel(gx, gx_want) <= 1e-5


# ---------------------------------------------------------------------------
# (c) the dry run's two layouts
# ---------------------------------------------------------------------------

def test_dryrun_multichip_on_four_cpu_ranks(one_thread):
    """``dryrun_multichip(4, "cpu")``: dp4 and dp2tp2, each against one
    process over its data axis's row groups: loss 1e-6, captions token for
    token, replicated parameters bit-equal on all ranks and every shard
    across its data peers, updates within 1e-3 lr (it raises otherwise)."""
    from grit_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", deadline=DEADLINE)
    assert list(out["layouts"]) == ["dp4", "dp2tp2"]
    split = out["layouts"]["dp2tp2"]["split"]
    assert out["layouts"]["dp4"]["split"] == [] and "cap_generator.fc.weight" in split
    assert len(split) == 19                # 6 FFNs x (fc1 weight and bias, fc2) + the head
    for res in out["layouts"].values():
        assert abs(res["loss"] - res["ref_loss"]) <= 1e-6 * abs(res["ref_loss"])
        assert res["captions"] == [8, 3, 10]


# ---------------------------------------------------------------------------
# (d) and (e): dp2tp2 over 4 gloo ranks against grit_tpu
# ---------------------------------------------------------------------------

def test_dp2tp2_xe_step_matches_jax(one_thread, tp):
    """Four ranks in dp2tp2 (``make_groups``: tensor groups {0, 1}, {2, 3}),
    each data group's rows dealt as ``shard_batch(tree, dp_rank, 2)``, against
    grit_tpu's XE step on one device given the union batch: loss 1e-6
    relative, every gradient (the shards gathered) and updated parameter as
    ``test_xe_step_over_two_ranks_matches_jax`` holds them; replicated
    parameters bit-equal on all ranks, each shard across its data peers."""
    from test_torch_parallel import check_grads, check_update, jax_xe, xe_inputs
    from test_torch_train import BACKBONE_LR, torch_train_captioner

    imgs, mask, caps = xe_inputs(ROWS)
    loss, _, ref_g, ref_p, lr = jax_xe(torch_train_captioner(), imgs, mask, caps)
    assert [o["ddp"] for o in tp] == ["DistributedDataParallel"] * WORLD
    split = set(tp[0]["split"])
    assert "cap_generator.fc.weight" in split and len(tp[0]["plan"]) == 17
    for o in tp:
        assert abs(o["loss"] - loss) <= 1e-6 * abs(loss)
        assert abs(o["lr"] - lr) <= 2e-6 * lr
        for name, p in o["own"].items():
            peers = [q for q in tp if name not in split or q["tp_rank"] == o["tp_rank"]]
            assert all(torch.equal(p, q["own"][name]) for q in peers), name
    assert check_grads(tp[0]["grads"], ref_g) > 150
    check_update(tp[0]["params"], ref_p, ref_g, lambda n: BACKBONE_LR if "detector" in n else lr)


def test_dp2tp2_beam_captions_match_jax(one_thread, tp):
    """The ranks' beam-3 captions of the initial weights (each data rank's
    rows; the two ranks of a tensor group alike) against grit_tpu's
    ``make_generate_step`` on the union batch, every beam token for token."""
    import jax.numpy as jnp

    from grit_tpu.engine import scst as jscst
    from grit_tpu.utils.nested import ImageBatch as JaxBatch
    from test_torch_models import BOS, EOS, jax_captioner, jax_params
    from test_torch_parallel import xe_inputs
    from test_torch_train import torch_train_captioner

    imgs, mask, _ = xe_inputs(ROWS)
    params = {"params": jax_params(torch_train_captioner())}
    want = np.asarray(jscst.make_generate_step(jax_captioner(), beam_size=BEAM, max_len=STEPS,
                                               bos_idx=BOS, eos_idx=EOS)(
        params, JaxBatch(jnp.asarray(imgs), jnp.asarray(mask)), ROWS)[0])
    got = np.zeros_like(want)
    for o in tp:
        got[o["dp_rank"]::DP] = o["sequences"].numpy()
    for a, b in ((tp[0], tp[1]), (tp[2], tp[3])):
        assert torch.equal(a["sequences"], b["sequences"])
    np.testing.assert_array_equal(got, want)


def test_gather_tp_state_restores_the_state_bit_for_bit(tp):
    """``gather_tp_state`` after ``shard_model`` gives every rank the original
    state_dict, key for key and bit for bit; the plan holds the 17 weights
    of grit_tpu's rules at this twin's shapes (4 Swin MLPs, 4 FFNs, the
    head) and each rank holds half of each split dim."""
    for o in tp:
        assert o["restored"].keys() == o["before"].keys()
        for k, v in o["before"].items():
            assert torch.equal(o["restored"][k], v), k
        for name, dim in o["plan"].items():
            assert o["own"][name].shape[dim] * TP == o["before"][name].shape[dim]
