"""The port's data parallel (``grit_tpu_torch.parallel``) on the CPU: two gloo
ranks against the JAX package on one device given the union batch, and
against the port's own one process.

The ranks run in fresh processes (``parallel.distributed.run_ranks``, the
variables ``torchrun`` sets, one CPU thread each) over the bodies in
``tests/torch_parallel_ranks.py``, which import no JAX; every start has a
deadline past which its ranks are killed and the test fails.  One start
serves the step cases (``dp``); the CLI and the dry run start their own.
Tiny twins in fp32, dropouts off (each rank draws its own masks).

Tolerances: losses 1e-6 relative (the detector's, after its host matching
and clip, and SCST's 1e-5, as their one-process tests); a gradient leaf 1e-4
of its max (plus 1e-7); an updated parameter 1e-4 of its max where the
gradient is above 1e-6 and two learning rates elsewhere (Adam's first step is
rounding noise of either sign there), as tests/test_torch_train.py holds a
step; scores, ids and captions exactly.
"""

import copy
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grit_tpu.detection import losses as jlosses
from grit_tpu.detection import solver as jsolver
from grit_tpu.engine import optim as joptim
from grit_tpu.engine import scst as jscst
from grit_tpu.engine import xe as jxe
from grit_tpu.utils.nested import ImageBatch as JaxBatch
from grit_tpu_torch import convert
from grit_tpu_torch.data.coco import CocoLoader
from grit_tpu_torch.detection.coco_eval import CocoEvaluator
from grit_tpu_torch.detection.loader import DetectionLoader
from grit_tpu_torch.engine import optim as toptim
from grit_tpu_torch.engine import xe as txe
from grit_tpu_torch.engine.evaluator import evaluate_metrics, make_caption_generator
from grit_tpu_torch.parallel import mesh
from grit_tpu_torch.parallel.distributed import allgather_pyobj, run_ranks
from grit_tpu_torch.utils.nested import ImageBatch
from test_torch_det_train import CLIP, HYPER, LR_SCALES, SP_NAMES, torch_det_batch, det_targets
from test_torch_detection import N_CLASSES, det_params, jax_detector, torch_detector
from test_torch_models import (BOS, BUCKET, EOS, PAD, VOCAB, jax_params,
                               torch_one_thread)  # noqa: F401
from test_torch_train import (BACKBONE_LR, FROZEN_STAGES, SCHED, jax_train_captioner,
                              torch_batch, torch_state, torch_train_captioner)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
DEADLINE = 300.0      # seconds a start of the ranks may take
BEAM, SC_LR = 3, 1e-4


def ranks(target: str, *args, **kwargs) -> list:
    return run_ranks(f"torch_parallel_ranks:{target}", WORLD, args=args, kwargs=kwargs,
                     paths=[HERE], deadline=DEADLINE)


def ragged_images(rows: int, seed: int = 5):
    """uint8 images in BUCKET, every other one smaller than it."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((rows, *BUCKET, 3), np.uint8)
    mask = np.ones((rows, *BUCKET), bool)
    for i in range(rows):
        h, w = BUCKET if i % 2 == 0 else (40, 72)
        imgs[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        mask[i, :h, :w] = False
    return imgs, mask


def ragged_captions(rows: int, seed: int = 31, length: int = 9):
    caps = np.random.default_rng(seed).integers(4, VOCAB, (rows, length))
    caps[:, 0] = BOS
    for i in range(rows):
        caps[i, length - 1 - i % 4:] = PAD
    return caps


def xe_inputs(rows: int):
    if rows == 2:
        b = torch_batch()
        return b["samples"].images.numpy(), b["samples"].mask.numpy(), b["captions"].numpy()
    return (*ragged_images(rows), ragged_captions(rows))


def jax_xe(model, imgs, mask, caps):
    """grit_tpu's XE step on one device from the port's weights -> (loss,
    validation loss, gradients and updated parameters by port name, lr)."""
    params = {"params": jax.tree.map(np.copy, jax_params(model))}
    jmodel = jax_train_captioner()
    jbatch = {"samples": JaxBatch(jnp.asarray(imgs), jnp.asarray(mask)),
              "captions": jnp.asarray(caps)}

    def jloss(p):
        out = jmodel.apply(p, jbatch["samples"], jbatch["captions"], deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jxe.nll_loss(out, jbatch["captions"], PAD)[0]

    loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
    val = jxe.make_eval_loss_step(jmodel, pad_idx=PAD)(params, jbatch)
    tx, labels = joptim.build_optimizer(params)
    freeze = joptim.frozen_mask(params, joptim.swin_frozen_stages_predicate(FROZEN_STAGES))
    jstep = jxe.make_xe_train_step(jmodel, tx, labels, pad_idx=PAD, sched_cfg=SCHED,
                                   backbone_lr=BACKBONE_LR, freeze=freeze, donate=False)
    jstate, jm = jax.block_until_ready(jstep(jxe.TrainState.create(params, tx).epoch_tick(),
                                             jbatch, jax.random.PRNGKey(0)))
    sd = lambda t: convert.params_to_state_dict(jax.tree.map(np.asarray, t["params"]))  # noqa
    return float(loss), float(val), sd(grads), sd(jstate.params), float(jm["lr"])


def check_update(params: dict, ref_p: dict, ref_g: dict, lr_of) -> None:
    """Every leaf within 1e-4 of its max where the reference gradient is
    above 1e-6, within two learning rates elsewhere."""
    for name, p in params.items():
        ref = np.asarray(ref_p[name])
        g = ref_g.get(name)
        big = np.zeros(ref.shape, bool) if g is None else np.abs(np.asarray(g)) > 1e-6
        err = np.abs(np.asarray(p) - ref)
        assert (err <= np.where(big, 1e-4 * np.abs(ref).max(), 2 * lr_of(name))).all(), name


def check_grads(grads: dict, ref_g: dict) -> int:
    n = 0
    for name, g in grads.items():
        if g is None:   # frozen, or off the path (class / box heads, level_embed)
            continue
        n += 1
        ref = np.asarray(ref_g[name])
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-7, name
    return n


# ---------------------------------------------------------------------------
# one start of the ranks for the step cases
# ---------------------------------------------------------------------------

def xe_call(rows: int):
    imgs, mask, caps = xe_inputs(rows)
    batch = {"samples": ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)),
             "captions": torch.from_numpy(caps)}
    return ("xe_step", (torch_train_captioner(), batch),
            dict(sched=SCHED, backbone_lr=BACKBONE_LR, frozen_stages=FROZEN_STAGES, pad=PAD,
                 bos=BOS))


def scst_inputs():
    imgs, mask = ragged_images(2, seed=8)
    rng = np.random.default_rng(50)
    seqs = rng.integers(4, VOCAB, (2, BEAM, 7))
    seqs[0, 1, 4:] = [EOS, 0, 0]
    seqs[1, 2, 2:] = [EOS, 0, 0, 0, 0]
    rewards = (rng.random((2, BEAM)) * 2).astype(np.float32)
    return imgs, mask, seqs, rewards


def valid_gt() -> dict:
    return {i: {"boxes": np.asarray([[10. + i, 20., 90., 100.], [50., 40., 150., 120. + i]]),
                "labels": np.asarray([1 + i % 3, 3])} for i in range(5)}


def valid_preds() -> dict:
    rng = np.random.default_rng(9)
    out = {}
    for i, g in valid_gt().items():
        boxes = np.concatenate([g["boxes"] + rng.normal(0, 4, g["boxes"].shape),
                                rng.uniform(0, 150, (3, 4)).cumsum(-1)])
        out[i] = {"scores": rng.random(len(boxes)), "labels": np.asarray([1, 3, 2, 1, 3]),
                  "boxes": boxes}
    return out


WORDS = [f"w{i}" for i in range(VOCAB - 4)]


def eval_splits() -> dict:
    """Two splits of uint8 images with reference captions: valid (3 images in
    b2 batches) and test (2)."""
    out = {}
    for split, rows, seed in (("valid", 3, 11), ("test", 2, 12)):
        imgs, mask = ragged_images(rows, seed)
        refs = [[" ".join(WORDS[(seed + i + j) % 20:(seed + i + j) % 20 + 4])
                 for j in range(2)] for i in range(rows)]
        out[split] = [{"samples": ImageBatch(torch.from_numpy(imgs[s:s + 2]),
                                             torch.from_numpy(mask[s:s + 2])),
                       "captions": refs[s:s + 2], "image_id": list(range(s, min(s + 2, rows)))}
                      for s in range(0, rows, 2)]
    return out


def eval_model():
    torch.manual_seed(0)
    return torch_train_captioner(seed=3).eval()


@pytest.fixture(scope="module")
def dp():
    """Every step case's ranks, started once: XE on 2 rows, XE on a ragged 5
    (3 + 2 and a pad row), SCST, the detector step, and the exchanges."""
    imgs, mask, seqs, rewards = scst_inputs()
    det = torch_det_batch()
    calls = [
        xe_call(2), xe_call(5),
        ("scst_step", (torch_train_captioner(), ImageBatch(torch.from_numpy(imgs),
                                                          torch.from_numpy(mask)),
                       torch.from_numpy(seqs), torch.from_numpy(rewards), 2),
         dict(model_lr=SC_LR, backbone_lr=BACKBONE_LR, frozen_stages=FROZEN_STAGES, pad=PAD,
              bos=BOS, eos=EOS)),
        ("detector_step", (torch_detector(), det),
         dict(num_classes=N_CLASSES, hyper=HYPER, sp_names=SP_NAMES, clip=CLIP,
              lr_scales=LR_SCALES)),
        ("exchange", (valid_gt(), valid_preds(), eval_model(), eval_splits(), WORDS), {}),
    ]
    out = ranks("run_all", calls)
    return {name: [o[i] for o in out] for i, name in enumerate(
        ("xe2", "xe5", "scst", "detector", "exchange"))}


@pytest.mark.parametrize("rows", [2, 5])
def test_xe_step_over_two_ranks_matches_jax(torch_one_thread, dp, rows):
    """Two ranks' XE step (rows r, r + 2, ...; at 5 rows rank 1 pads its third
    row as [BOS, pad...]) against grit_tpu's step on one device given the
    union batch, unpadded: loss 1e-6 relative, the validation loss of the
    initial weights 1e-6, every all-reduced gradient and updated parameter as
    the module docstring says, and the two ranks' parameters bit-equal."""
    imgs, mask, caps = xe_inputs(rows)
    model = torch_train_captioner()
    loss, val, ref_g, ref_p, lr = jax_xe(model, imgs, mask, caps)
    out = dp[f"xe{rows}"]
    assert [o["rows"] for o in out] == [(rows + 1) // 2] * 2
    assert all(o["ddp"] == "DistributedDataParallel" for o in out)
    for o in out:
        assert abs(o["loss"] - loss) <= 1e-6 * abs(loss)
        assert abs(o["val_loss"] - val) <= 1e-6 * abs(val)
        assert abs(o["lr"] - lr) <= 2e-6 * lr
    for name, p in out[0]["params"].items():
        assert torch.equal(p, out[1]["params"][name]), name
    assert check_grads(out[0]["grads"], ref_g) > 150
    check_update(out[0]["params"], ref_p, ref_g,
                 lambda n: BACKBONE_LR if "detector" in n else lr)


def test_xe_step_over_two_ranks_matches_one_process(torch_one_thread, dp):
    """The same two ranks against the port's own one-process step on the 2
    rows: loss 1e-6 relative, gradients and updates as the module docstring
    says.  Under DDP a parameter has no gradient where one process computes
    none (off the path: class / box heads, level_embed) or the optimizer
    holds it not (frozen stages, pos_emb)."""
    model = torch_train_captioner()
    state = torch_state(model)
    state, metrics = txe.make_xe_train_step(pad_idx=PAD, sched_cfg=SCHED)(state, torch_batch())
    out = dp["xe2"][0]
    assert abs(out["loss"] - float(metrics["loss"])) <= 1e-6 * abs(float(metrics["loss"]))
    grads = {n: p.grad for n, p in model.named_parameters()}
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert {n for n, g in out["grads"].items() if g is None} == {
        n for n, p in model.named_parameters() if p.grad is None or id(p) not in held}
    check_grads(out["grads"], {n: g.numpy() for n, g in grads.items() if g is not None})
    check_update(out["params"], {n: p.detach().numpy() for n, p in model.named_parameters()},
                 {n: g.numpy() for n, g in grads.items() if g is not None},
                 lambda n: BACKBONE_LR if "detector" in n else metrics["lr"])


def test_scst_update_over_two_ranks_matches_jax(torch_one_thread, dp):
    """Two ranks' SCST update, an image each, normalised by the global image
    count, against grit_tpu's update on one device with n_valid = 2: loss,
    reward and baseline 1e-5 relative, gradients and updates as the module
    docstring says."""
    imgs, mask, seqs, rewards = scst_inputs()
    model = torch_train_captioner()
    params = {"params": jax.tree.map(np.copy, jax_params(model))}
    jmodel = jax_train_captioner()
    jsamples = JaxBatch(jnp.asarray(imgs), jnp.asarray(mask))

    def jloss(p):
        logp = jscst.sequence_log_probs(jmodel, p, jsamples, jnp.asarray(seqs), bos_idx=BOS,
                                        eos_idx=EOS, rng=jax.random.PRNGKey(0))
        adv = rewards - rewards.mean(-1, keepdims=True)
        return (-logp.mean(-1) * adv).sum() / (2.0 * BEAM)

    _, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tx, labels = joptim.build_optimizer(params)
    freeze = joptim.frozen_mask(params, joptim.swin_frozen_stages_predicate(FROZEN_STAGES))
    jstep = jscst.make_scst_update_step(jmodel, tx, labels, bos_idx=BOS, eos_idx=EOS,
                                        model_lr=SC_LR, backbone_lr=BACKBONE_LR, freeze=freeze)
    jstate, jm = jax.block_until_ready(jstep(
        jxe.TrainState.create(jax.tree.map(jnp.array, params), tx), jsamples,
        jnp.asarray(seqs), jnp.asarray(rewards), np.float32(2.0), jax.random.PRNGKey(0)))
    out = dp["scst"]
    for o in out:
        for key in ("loss", "reward", "reward_baseline"):
            assert abs(o["metrics"][key] - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
    sd = lambda t: convert.params_to_state_dict(jax.tree.map(np.asarray, t["params"]))  # noqa
    ref_g, ref_p = sd(ref_grads), sd(jstate.params)
    assert check_grads(out[0]["grads"], ref_g) > 150
    check_update(out[0]["params"], ref_p, ref_g,
                 lambda n: BACKBONE_LR if "detector" in n else SC_LR)


def test_detector_step_over_two_ranks_matches_jax(torch_one_thread, dp):
    """Two ranks' detector step, an image each (host matching per image, the
    box count all-reduced, the clip after DDP's all-reduce), against
    grit_tpu's step on one device with match_impl="host": loss and the
    gradient norm 1e-5 relative, updates as the module docstring says (of the
    clipped gradient); ``level_embed`` is off the path, out of DDP."""
    model = torch_detector()
    params = det_params(model)
    jmodel = jax_detector()
    jcrit = jlosses.SetCriterion(N_CLASSES, match_impl="host")
    imgs, mask = (t.numpy() for t in torch_det_batch()["samples"])
    jimages = JaxBatch(jnp.asarray(imgs), jnp.asarray(mask))
    jtargets = {k: jnp.asarray(v) for k, v in det_targets().items()}

    def jloss(p):
        out = jmodel.apply(p, jimages, training=True, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jcrit.total_loss(jcrit(out, jtargets))

    _, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tx, _ = joptim.build_optimizer(params, beta_2=0.999)
    labels = joptim.detector_param_labels(params, sp_names=SP_NAMES)
    jstep = jsolver.make_detector_train_step(jmodel, jcrit, tx, labels, clip_max_norm=CLIP,
                                             **HYPER)
    jstate, jm = jax.block_until_ready(jstep(
        jxe.TrainState.create(jax.tree.map(jnp.asarray, params), tx), jimages, jtargets,
        jnp.asarray(LR_SCALES, jnp.float32), jax.random.PRNGKey(0)))
    out = dp["detector"]
    for o in out:
        assert abs(o["loss"] - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(o["grad_norm"] - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
    assert "det_module.level_embed" in out[0]["off_path"]
    clip = min(1.0, CLIP / (float(jm["grad_norm"]) + 1e-6))
    ref_g = {n: g * clip for n, g in convert.params_to_state_dict(
        jax.tree.map(np.asarray, ref_grads["params"])).items()}
    ref_p = convert.params_to_state_dict(jax.tree.map(np.asarray, jstate.params["params"]))
    opt = toptim.build_detector_optimizer(model, sp_names=SP_NAMES, **HYPER)
    toptim.apply_detector_lr(opt, *LR_SCALES)
    lrs = {n: g["lr"] for g in opt.param_groups
           for n, p in model.named_parameters() if any(p is q for q in g["params"])}
    check_update(out[0]["params"], ref_p, ref_g, lambda n: lrs[n])
    for name, p in out[0]["params"].items():
        assert torch.equal(p, out[1]["params"][name]), name


def test_allgather_pyobj_and_the_coco_merge(dp):
    """``allgather_pyobj`` gives every rank every rank's object in rank
    order; ``CocoEvaluator.synchronize_between_processes`` merges two shards
    (3 + 2 images) into one process's predictions, and the mAP is one
    process's exactly.  One process: the identity."""
    out = dp["exchange"]
    want = [{"rank": 0, "payload": [0]}, {"rank": 1, "payload": [0, 1]}]
    assert [o["gathered"] for o in out] == [want, want]
    assert [o["held"] for o in out] == [3, 2]
    one = CocoEvaluator(valid_gt())
    one.update(sorted(valid_preds()), [valid_preds()[i] for i in sorted(valid_preds())])
    assert allgather_pyobj("solo") == ["solo"]
    one.synchronize_between_processes()
    summary = one.summarize()
    assert summary["mAP"] > 0
    for o in out:
        assert o["merged"] == sorted(valid_gt()) and o["summary"] == summary


def test_rank_specialised_evaluation_matches_one_process(torch_one_thread, dp):
    """``evaluate_splits`` over two ranks: valid runs on rank 0, test on rank
    1, and each rank ends up with both splits' scores, equal to one process's
    evaluation of each split (beam 2, 5 steps)."""
    from grit_tpu_torch.data.field import TextField
    from grit_tpu_torch.data.vocab import Vocab

    text_field = TextField(vocab=Vocab(counter=Counter({t: 5 for t in WORDS})),
                           eos_token="<off>")
    generate = make_caption_generator(eval_model(), beam_size=2, max_len=5, bos_idx=2,
                                      eos_idx=3)
    want = {split: evaluate_metrics(generate, batches, text_field, device="cpu",
                                    verbose=False)[0]
            for split, batches in eval_splits().items()}
    for o in dp["exchange"]:
        assert list(o["scores"]) == ["valid", "test"] and o["scores"] == want


# ---------------------------------------------------------------------------
# in one process: the loaders' dealing, the padding helpers
# ---------------------------------------------------------------------------

class _Features:
    """Stands in for the hdf5 reader: image i's features are [i]."""

    def read(self, i):
        return {"gri_feat": np.asarray([float(i)], np.float32)}


@pytest.mark.parametrize("n, drop_last", [(7, False), (7, True), (9, False), (3, False)])
def test_caption_loader_deals_one_process_batches(n, drop_last):
    """At 2 ranks of b2 every rank runs as many batches, the one process's
    count at b4; rank r's batch t is idx[r::2][2t : 2t + 2], so the two
    together are the one-process batch t (idx[4t : 4t + 4]); a rank's share
    of the last batch may be short or empty (no samples, no rows)."""
    data = [(None, 100 + i) for i in range(n)]

    def loader(rank, world, b):
        return CocoLoader(data, b, hdf5=_Features(), mode="test", shuffle=True,
                          drop_last=drop_last, rank=rank, world=world, seed=3, num_workers=1)

    one = [batch["image_id"] for batch in loader(0, 1, 4)]
    per_rank = [[batch["image_id"] for batch in loader(r, 2, 2)] for r in range(2)]
    want = n // 4 if drop_last else -(-n // 4)
    assert len(one) == want and [len(p) for p in per_rank] == [want, want]
    assert [len(loader(r, 2, 2)) for r in range(2)] == [want, want]
    for t in range(want):
        assert sorted(per_rank[0][t] + per_rank[1][t]) == sorted(one[t])
    if n == 9:
        assert per_rank[1][-1] == []          # 9 = 2 * 4 + 1: rank 1 has nothing left
        assert next(b for i, b in enumerate(loader(1, 2, 2)) if i == want - 1)["samples"] is None


def test_detection_loader_counts_one_process_batches():
    """Training drops the short tail at the global batch (a padded image would
    add background focal terms); validation deals every image, the last
    shares short or empty."""
    data = list(range(9))
    for mode, want in (("train", 9 // 4), ("valid", -(-9 // 4))):
        lens = [len(DetectionLoader(data, 2, transform=None, mode=mode, rank=r, world=2))
                for r in range(2)]
        assert lens == [want, want], mode
    one = len(DetectionLoader(data, 2, transform=None, mode="valid"))
    assert one == 5


def test_pad_and_shard_batch_follow_the_jax_conventions():
    """``pad_to_multiple`` pads as grit_tpu's (caption rows [BOS, pad...],
    zero images and features, uint8 images with zeros) and ``shard_batch``
    deals rows r, r + world, ...; the lists keep their real rows only."""
    from grit_tpu.parallel.mesh import pad_to_multiple as jpad

    caps = np.asarray([[2, 5, 6, 3, 1]] * 5, np.int32)
    feats = np.random.default_rng(0).random((5, 3)).astype(np.float32)
    imgs = np.full((5, 2, 2, 3), 7, np.uint8)
    tree = {"captions": caps, "feat": feats, "images": imgs}
    got = mesh.pad_to_multiple(tree, 4, int_fill=PAD, int_first=BOS)
    want = jpad(tree, 4, int_fill=PAD, int_first=BOS)
    for k in tree:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["captions"][5:].tolist() == [[BOS] + [PAD] * 4] * 3
    parts = [mesh.shard_batch({**tree, "ids": list(range(5))}, r, 2, int_fill=PAD,
                              int_first=BOS) for r in range(2)]
    assert [p["captions"].shape[0] for p in parts] == [3, 3]
    assert [p["ids"] for p in parts] == [[0, 2, 4], [1, 3]]
    np.testing.assert_array_equal(parts[1]["feat"][:2], feats[1::2])
    assert not parts[1]["feat"][2].any()
    assert mesh.unwrap(torch.nn.Linear(2, 2)).weight.shape == (2, 2)
    assert float(mesh.global_sum(torch.tensor(3.0))) == 3.0     # one process


# ---------------------------------------------------------------------------
# the CLI and the dry run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from synth_coco import make_synth_coco

    root = tmp_path_factory.mktemp("synth_coco_dp")
    return str(root), make_synth_coco(root)


def test_train_caption_over_two_ranks(synth_root, monkeypatch, tmp_path):
    """``train_caption.main([... "exp.device=cpu"])`` under WORLD_SIZE=2 on
    the synthetic fixture (1 XE and 1 SC epoch, b2 a rank): both ranks train
    under DDP to the same parameters, ``result.csv`` is written once (the
    valid and test rows of each epoch), the checkpoint roles are there, and
    the best-valid checkpoint loads into a one-process model, strictly; the
    last one carries both ranks' dropout generators."""
    from grit_tpu_torch.config import default_caption_config
    from grit_tpu_torch.engine import checkpoint as tckpt
    from grit_tpu_torch.eval_caption import load_any_checkpoint
    from grit_tpu_torch.models.captioner import build_captioner

    root, vocab_size = synth_root
    monkeypatch.setenv("DATA_ROOT", root)
    overrides = ["exp.name=dp", f"model.vocab_size={vocab_size}",
                 "dataset.transform_cfg.size=[64, 96]", "model.backbone=swin_test",
                 "model.grid_feat_dim=64", "model.detector.num_levels=2",
                 "dataset.transform_cfg.randaug=false", "optimizer.batch_size=2",
                 "optimizer.num_workers=1", "optimizer.finetune_xe_epochs=1",
                 "optimizer.finetune_sc_epochs=1", "model.beam_size=2", "model.beam_len=6",
                 "model.max_len=12", "model.cap_generator.n_layers=1",
                 "model.grid_net.n_layers=1", "model.detector.num_layers=2", "exp.device=cpu"]
    out = ranks("train_caption_cli", str(tmp_path), overrides)
    assert [o["ddp"] for o in out] == ["DistributedDataParallel"] * 2
    assert out[0]["params"] == out[1]["params"] and out[0]["steps"] == out[1]["steps"] > 0
    workdir = tmp_path / "outputs" / "dp"
    rows = (workdir / "result.csv").read_text().splitlines()
    assert len(rows) == 1 + 2 * 2
    assert [r.split(", ")[6].strip() for r in rows[1:]] == ["valid", "test"] * 2
    assert sorted(os.listdir(workdir / "checkpoints")) == [
        "best_test", "best_valid", "ft_sc", "ft_xe", "last"]
    config = default_caption_config().apply_overrides(overrides)
    model = build_captioner(config, device="cpu", seed=None)
    payload = tckpt.restore_checkpoint(str(workdir), "best_valid")
    model.load_state_dict(payload["state_dict"], strict=True)
    load_any_checkpoint(str(workdir / "checkpoints" / "last"), model)
    last = {n: float(p.detach().double().sum()) for n, p in model.named_parameters()}
    assert last == out[0]["params"]
    assert len(tckpt.restore_checkpoint(str(workdir), "last")["generator_states"]) == 2


def test_dryrun_multichip_on_two_cpu_ranks(torch_one_thread):
    """``dryrun_multichip(2, device="cpu")``: the XE loss, the updated
    parameters and the beam-search captions of two gloo ranks equal one
    process's (it raises otherwise)."""
    from grit_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(2, device="cpu", deadline=DEADLINE)
    assert abs(out["loss"] - out["ref_loss"]) <= 1e-6 * abs(out["ref_loss"])
    assert out["captions"] == [4, 3, 10]


def test_maybe_initialize_is_a_no_op_without_a_launcher(monkeypatch):
    """Without a launcher's variables nothing starts: rank 0 of 1."""
    from grit_tpu_torch.parallel.distributed import maybe_initialize

    for var in ("MASTER_ADDR", "WORLD_SIZE", "COORDINATOR_ADDRESS", "NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize("cpu") == (0, 1)
    assert not torch.distributed.is_initialized()


def test_rendezvous_reads_torchrun_and_jax_variables(monkeypatch):
    """torchrun's variables, else the JAX CLI's (``tcp://`` on its coordinator
    address), else none; a bare ``cuda`` is the card LOCAL_RANK names."""
    from grit_tpu_torch.parallel import distributed as d

    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK", "COORDINATOR_ADDRESS",
                "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert d._rendezvous() is None
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    assert d._rendezvous() == (3, 4, 3, "tcp://10.0.0.1:1234")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert d._rendezvous() == (5, 8, 1, "env://")
    assert d.rank_device("cuda") == torch.device("cuda", 1)
    assert d.rank_device("cpu") == torch.device("cpu")
    assert d.rank_device("cuda:0") == torch.device("cuda", 0)


def test_wrap_data_parallel_is_the_model_on_one_rank():
    model = torch.nn.Linear(2, 2)
    assert mesh.wrap_data_parallel(model, "cpu", probe=lambda m: 1 / 0) is model
    assert copy.deepcopy(model).weight.requires_grad
