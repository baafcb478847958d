"""The port's caption trainer against the JAX package, on the CPU: the copied
metric and COCO loader modules (exact), the phase machine and result.csv
lines, ``evaluate_metrics`` on the same weights, the ``torch.save`` checkpoint
round trip, and ``python -m grit_tpu_torch.train_caption`` end to end on the
synthetic Karpathy fixture of tests/synth_coco.py (tiny model, 1 XE + 1 SC
epoch, then a resume inside SC).
"""

import os

import numpy as np
import pytest
import torch

from synth_coco import make_synth_coco
from test_torch_models import (BOS, VOCAB, jax_captioner, jax_params, torch_captioner,
                               torch_one_thread)  # noqa: F401
from test_torch_train import (PAD, SCHED, torch_batch, torch_state, torch_train_captioner)

SIZE = "dataset.transform_cfg.size=[64, 96]"
TINY_MODEL = ["model.backbone=swin_test", "model.grid_feat_dim=64", "model.detector.num_levels=2"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_coco")
    return str(root), make_synth_coco(root)


def _configs(data_root, monkeypatch, extra=()):
    from grit_tpu import config as jconfig
    from grit_tpu_torch import config as tconfig

    root, vocab_size = data_root
    monkeypatch.setenv("DATA_ROOT", root)
    overrides = [f"model.vocab_size={vocab_size}", SIZE, "dataset.transform_cfg.randaug=false",
                 "optimizer.batch_size=2", "optimizer.num_workers=2", *extra]
    return (tconfig.default_caption_config().apply_overrides(overrides),
            jconfig.default_caption_config().apply_overrides(overrides))


# ---------------------------------------------------------------------------
# copied jax-free modules
# ---------------------------------------------------------------------------

GTS = {"a": ["a red thing number 1 doing stuff 0", "a red thing number 1 doing stuff 1"],
       "b": ["a blue cat is running", "two blue cats running fast", "the cat runs"],
       "c": ["a dog"]}
GEN = {"a": ["a red thing number 1 doing stuff"], "b": ["a blue cat running running"],
       "c": ["a cat"]}


@pytest.mark.parametrize("metric", ["Bleu", "Cider", "Rouge", "Meteor", "Cider_corpus_idf",
                                    "compute_scores", "porter_stem", "Cider_native",
                                    "Cider_native_corpus_idf"])
def test_port_metric_modules_match_jax_package(metric):
    """The port's copies of the metric modules give the JAX package's scores
    on the same captions, exactly: each Cider on its pure-Python path, and
    (``Cider_native*``) each on its native library, the same C++ source."""
    from grit_tpu.data import metrics as jm
    from grit_tpu.data.metrics.stemmer import porter_stem as jstem
    from grit_tpu_torch.data import metrics as tm
    from grit_tpu_torch.data.metrics.stemmer import porter_stem as tstem

    if metric == "porter_stem":
        words = "running cats relational conditional rational valency digitizer hopefulness a".split()
        assert [tstem(w) for w in words] == [jstem(w) for w in words]
        return
    if metric == "compute_scores":
        ours, theirs = tm.compute_scores(GTS, GEN), jm.compute_scores(GTS, GEN)
        assert ours[0].keys() == theirs[0].keys() == {"BLEU", "METEOR", "ROUGE", "CIDEr"}
        for key in ("BLEU", "METEOR", "ROUGE"):    # both Ciders take their native libraries
            assert np.array_equal(np.asarray(ours[0][key]), np.asarray(theirs[0][key])), key
            assert np.array_equal(np.asarray(ours[1][key]), np.asarray(theirs[1][key])), key
        assert abs(ours[0]["CIDEr"] - theirs[0]["CIDEr"]) <= 1e-9
        return
    if metric.startswith("Cider"):
        corpus = GTS if metric.endswith("idf") else None
        native = metric.startswith("Cider_native")
        ours, theirs = tm.Cider(corpus, use_native=native), jm.Cider(corpus, use_native=native)
    else:
        ours, theirs = getattr(tm, metric)(), getattr(jm, metric)()
    assert str(ours) == str(theirs)
    (a, per_a), (b, per_b) = ours.compute_score(GTS, GEN), theirs.compute_score(GTS, GEN)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(per_a), np.asarray(per_b))
    assert np.asarray(a).sum() > 0


@pytest.mark.parametrize("mode", ["finetune", "overfit"])
def test_port_coco_loaders_match_jax_package(data_root, monkeypatch, mode):
    """``build_coco_dataloaders`` of both packages on the synthetic Karpathy
    data: the same loaders with the same batch sizes and lengths, and at
    epochs 0 and 1 (the shuffle's seed) the same batches: images and masks,
    padded caption ids, reference captions and image ids, exactly."""
    from grit_tpu.data import coco as jcoco
    from grit_tpu_torch.data import coco as tcoco

    tcfg, jcfg = _configs(data_root, monkeypatch,
                          ["dataset.overfit=true"] if mode == "overfit" else [])
    ours, ours_s = tcoco.build_coco_dataloaders(tcfg, mode="finetune")
    theirs, theirs_s = jcoco.build_coco_dataloaders(jcfg, mode="finetune")
    assert list(ours) == list(theirs) and list(ours_s) == list(theirs_s)
    n_batches = 0
    for key in ours:
        a, b = ours[key], theirs[key]
        assert (a.batch_size, a.mode, a.shuffle, a.drop_last, len(a)) == (
            b.batch_size, b.mode, b.shuffle, b.drop_last, len(b)), key
        for epoch in (0, 1):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            batches = list(zip(a, b, strict=True))
            assert len(batches) == len(a)
            for x, y in batches:
                n_batches += 1
                assert x.keys() == y.keys()
                assert x["image_id"] == y["image_id"]
                assert isinstance(x["samples"].images, torch.Tensor)
                np.testing.assert_array_equal(x["samples"].images.numpy(),
                                              np.asarray(y["samples"].images))
                np.testing.assert_array_equal(x["samples"].mask.numpy(),
                                              np.asarray(y["samples"].mask))
                if a.mode == "paired":
                    assert x["captions"].dtype == y["captions"].dtype
                    np.testing.assert_array_equal(x["captions"], y["captions"])
                else:
                    assert x["captions"] == y["captions"]
    assert n_batches >= 8
    toks = [[4, 5], list(range(4, 30))]
    np.testing.assert_array_equal(tcoco.pad_captions(toks, 6), jcoco.pad_captions(toks, 6))
    assert tcoco.CocoExample._fields == jcoco.CocoExample._fields


def test_pad_leading_matches_pad_to_multiple():
    """The ragged-batch padder's conventions: zero images and masks, pad ids
    with a leading BOS; against grit_tpu.parallel.mesh.pad_to_multiple."""
    from grit_tpu.parallel.mesh import pad_to_multiple
    from grit_tpu_torch.engine.loops import ragged_padder
    from grit_tpu_torch.utils.nested import ImageBatch, pad_leading

    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    mask = rng.random((3, 8, 8)) > 0.5
    caps = rng.integers(4, 20, (3, 5)).astype(np.int32)
    ref = pad_to_multiple({"images": imgs, "mask": mask, "captions": caps}, 4, int_fill=1,
                          int_first=2)
    out = pad_leading({"samples": ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)),
                       "captions": caps}, 4, int_fill=1, int_first=2)
    np.testing.assert_array_equal(out["samples"].images.numpy(), ref["images"])
    np.testing.assert_array_equal(out["samples"].mask.numpy(), ref["mask"])
    np.testing.assert_array_equal(out["captions"], ref["captions"])
    assert out["captions"].dtype == caps.dtype and (out["captions"][3] == [2, 1, 1, 1, 1]).all()
    pad = ragged_padder(int_fill=1, int_first=2)
    assert pad(caps, 3) is caps and pad(caps[:2], 2).shape == (3, 5) and pad(caps, 3) is caps


def test_phase_machine_and_result_csv_match_jax_package(data_root, monkeypatch, tmp_path):
    from grit_tpu.engine import loops as jloops
    from grit_tpu_torch.engine import loops as tloops

    tcfg, jcfg = _configs(data_root, monkeypatch, [
        "optimizer.freezing_xe_epochs=2", "optimizer.freezing_sc_epochs=1",
        "optimizer.finetune_xe_epochs=3", "optimizer.finetune_sc_epochs=2", "exp.name=a/run7"])
    assert tloops.total_epochs(tcfg) == jloops.total_epochs(jcfg) == 8
    phases = [tloops.phase_for_epoch(e, tcfg) for e in range(10)]
    assert phases == [jloops.phase_for_epoch(e, jcfg) for e in range(10)]
    assert phases == ["fr_xe"] * 2 + ["fr_sc"] + ["ft_xe"] * 3 + ["ft_sc"] * 2 + ["done"] * 2
    scores = {"CIDEr": 1.2345, "BLEU": [0.8, 0.6, 0.4, 0.31234], "ROUGE": 0.5678, "METEOR": 0.2789}
    res = {"loss": 2.3456, "reward": 0.123, "reward_baseline": 0.1, "val_loss": 2.5}
    for e, split in ((0, "valid"), (5, "test")):
        tloops.log_epoch_csv(tcfg, e, split, scores, res, phases[e], path=str(tmp_path / "t.csv"))
        jloops.log_epoch_csv(jcfg, e, split, scores, res, phases[e], path=str(tmp_path / "j.csv"))
    lines = (tmp_path / "t.csv").read_text()
    assert lines == (tmp_path / "j.csv").read_text() and len(lines.splitlines()) == 3
    assert "run7, B-IM, 64_96" in lines


def test_scalar_writer_writes_jsonl(tmp_path):
    import json

    from grit_tpu_torch.engine.logger import ScalarWriter

    w = ScalarWriter(str(tmp_path / "tb"))
    w.scalar("model_lr", 1e-4, 3)
    w.add_scalar("model_lr", torch.tensor(2e-4), 4)
    w.close()
    rows = [json.loads(line) for line in open(tmp_path / "tb" / "scalars.jsonl")]
    assert [(r["tag"], r["step"]) for r in rows] == [("model_lr", 3), ("model_lr", 4)]
    assert abs(rows[1]["value"] - 2e-4) < 1e-9


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def test_evaluate_metrics_matches_jax(data_root, monkeypatch):
    """The same weights over the same dict-mode loader (batches of 3 and a
    ragged tail of 1, padded and cut back) give the JAX package's captions
    and scores; 1e-6 on every score."""
    from collections import Counter

    from grit_tpu.data import coco as jcoco
    from grit_tpu.data.field import TextField as JField
    from grit_tpu.data.vocab import Vocab as JVocab
    from grit_tpu.engine import evaluator as jev
    from grit_tpu_torch.data import coco as tcoco
    from grit_tpu_torch.data.field import TextField
    from grit_tpu_torch.data.vocab import Vocab
    from grit_tpu_torch.engine import evaluator as tev

    tcfg, jcfg = _configs(data_root, monkeypatch)
    words = Counter({w: 5 for w in "a thing number doing stuff red blue cat dog".split()}
                    | {f"w{i}": 5 for i in range(VOCAB - 13)})
    field, jfield = TextField(vocab=Vocab(counter=words)), JField(vocab=JVocab(counter=words))
    assert len(field.vocab) == VOCAB
    kw = dict(beam_size=3, max_len=6, bos_idx=BOS, eos_idx=3)
    model = torch_captioner()
    results = {}
    for name, coco, fld in (("port", tcoco, field), ("jax", jcoco, jfield)):
        loaders, _ = coco.build_coco_dataloaders(tcfg if name == "port" else jcfg)
        data = coco.DictionaryDataset(loaders["train"].dataset.examples)
        loader = coco.CocoLoader(data, 3, transform=loaders["valid_dict"].transform, mode="dict",
                                 bucket_hw=(64, 96), num_workers=2)
        assert len(loader) == 2 and len(data) == 4
        if name == "port":
            gen = tev.make_caption_generator(model, **kw)
            results[name] = tev.evaluate_metrics(gen, loader, fld, device="cpu", verbose=False)
        else:
            gen = jev.make_caption_generator(jax_captioner(), **kw)
            results[name] = jev.evaluate_metrics(gen, {"params": jax_params(model)}, loader, fld,
                                                 verbose=False)
    (scores, res, avg), (jscores, jres, _) = results["port"], results["jax"]
    assert res == jres and len(res) == 4 and avg > 0
    assert scores.keys() == jscores.keys()
    for key in scores:
        assert np.abs(np.asarray(scores[key]) - np.asarray(jscores[key])).max() <= 1e-6, key


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    """save -> restore into a freshly built model, optimizer and generator ->
    the next XE step (dropouts on) leaves both with the same parameters and
    moments, bit for bit; roles are directories with state.pth + config.yaml."""
    from grit_tpu_torch.config import default_caption_config
    from grit_tpu_torch.engine import checkpoint as ckpt
    from grit_tpu_torch.engine import xe as txe

    step = txe.make_xe_train_step(pad_idx=PAD, sched_cfg=SCHED)
    batch = torch_batch()
    state = torch_state(torch_train_captioner(dropout=0.2, det_dropout=0.1, drop_path=0.3), seed=5)
    step(state, batch)
    ckpt.save_checkpoint(str(tmp_path), "last", state=state, epoch=3, best_ciders=(0.5, 0.25),
                         config=default_caption_config())
    assert sorted(os.listdir(tmp_path / "checkpoints" / "last")) == ["config.yaml", "state.pth"]

    fresh = torch_state(torch_train_captioner(dropout=0.2, det_dropout=0.1, drop_path=0.3, seed=9),
                        seed=77)
    payload = ckpt.restore_checkpoint(str(tmp_path), "last")
    assert payload["epoch"] == 3 and payload["best_ciders"] == [0.5, 0.25]
    assert set(payload["state_dict"]) == set(state.model.state_dict())
    ckpt.load_train_state(fresh, payload)
    assert fresh.global_steps == state.global_steps == 2
    for st in (state, fresh):
        step(st, batch)
    for (n, a), (_, b) in zip(state.model.named_parameters(), fresh.model.named_parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(state.optimizer.state.values(), fresh.optimizer.state.values()):
        assert a["step"] == b["step"] == 2 and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    assert torch.equal(state.generator.get_state(), fresh.generator.get_state())

    # the SC warm-start takes the parameters only
    warm = torch_state(torch_train_captioner(seed=9), seed=1)
    ckpt.load_train_state(warm, payload, params_only=True)
    assert warm.global_steps == 1 and not warm.optimizer.state
    with pytest.raises(FileNotFoundError, match="not found"):
        ckpt.restore_checkpoint(str(tmp_path), "best_valid")
    assert ckpt.restore_checkpoint_path(str(tmp_path / "checkpoints" / "last"))["epoch"] == 3


def test_load_params_flexible_counts_like_the_jax_package():
    """A detector checkpoint with a missing, a reshaped and an unexpected
    entry: matching leaves are copied, the rest counted, as
    grit_tpu.engine.checkpoint.load_params_flexible counts them."""
    from grit_tpu.engine import checkpoint as jckpt
    from grit_tpu_torch import convert
    from grit_tpu_torch.engine import checkpoint as ckpt

    src = torch_captioner(seed=3).detector
    loaded = {k: v.clone() for k, v in src.state_dict().items()}
    dropped = "det_module.level_embed"
    del loaded[dropped]
    loaded["input_proj.0.1.bias"] = torch.zeros(3)
    loaded["extra.weight"] = torch.zeros(2, 2)
    dst = torch_captioner(seed=4).detector
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    miss, unexp = ckpt.load_params_flexible(dst, loaded)
    assert (miss, unexp) == (2, 1)
    for k, v in dst.state_dict().items():
        want = before[k] if k in (dropped, "input_proj.0.1.bias") else src.state_dict()[k]
        assert torch.equal(v, want), k
    full = {k: v.clone() for k, v in src.state_dict().items()}
    _, jmiss, junexp = jckpt.load_params_flexible(
        convert.state_dict_to_params(before),
        convert.state_dict_to_params({k: v for k, v in full.items() if k != dropped}))
    assert jmiss == 1 and junexp == 0
    prefixed = {"detector." + k: v for k, v in full.items()} | {"cap_generator.fc.weight": 0}
    assert ckpt.load_params_flexible(dst, prefixed, prefix="detector.") == (0, 0)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides, want", [
    ([], torch.float32),
    (["exp.device=cuda"], torch.float32),
    (["model.compute_dtype=bfloat16"], torch.bfloat16),
    (["exp.device=cpu", "model.compute_dtype=bfloat16"], torch.bfloat16),
])
def test_train_caption_compute_dtype_follows_the_config(data_root, monkeypatch, overrides, want):
    """The CLI computes in ``model.compute_dtype`` on either device: fp32 by
    default, as the config the JAX package's CLI reads."""
    from grit_tpu_torch.train_caption import _compute_dtype

    tconfig, jconfig = _configs(data_root, monkeypatch, overrides)
    assert tconfig.model.compute_dtype == jconfig.model.compute_dtype
    assert _compute_dtype(tconfig) is want


def test_train_caption_cli_refuses_missing_cuda(data_root, monkeypatch, tmp_path):
    from grit_tpu_torch.train_caption import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("DATA_ROOT", data_root[0])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["exp.name=nocuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["exp.name=nocuda", "--device", "cuda"])


def test_train_caption_cli_trains_evaluates_and_resumes(data_root, monkeypatch, tmp_path, capsys):
    """1 XE + 1 SC epoch on the synthetic fixture on the CPU: per-epoch
    evaluation of valid and test into result.csv, the checkpoint roles, the SC
    warm-start from best_valid; then a resume from ``last`` inside SC, which
    must not warm-start a second time."""
    from grit_tpu_torch.engine import checkpoint as ckpt
    from grit_tpu_torch.train_caption import main

    root, vocab_size = data_root
    monkeypatch.setenv("DATA_ROOT", root)
    monkeypatch.chdir(tmp_path)
    overrides = ["exp.name=cli", f"model.vocab_size={vocab_size}", SIZE, *TINY_MODEL,
                 "dataset.transform_cfg.randaug=false", "optimizer.batch_size=2",
                 "optimizer.num_workers=2", "optimizer.finetune_xe_epochs=1",
                 "optimizer.finetune_sc_epochs=1", "model.beam_size=2", "model.beam_len=6",
                 "model.max_len=12", "model.cap_generator.n_layers=1", "model.grid_net.n_layers=1",
                 "model.detector.num_layers=2", "exp.device=cpu"]
    state = main(overrides)
    out = capsys.readouterr().out
    assert "phase=ft_xe" in out and "phase=ft_sc" in out
    assert out.count("Start self-critical optimization from best_valid") == 1
    workdir = tmp_path / "outputs" / "cli"
    rows = (workdir / "result.csv").read_text().splitlines()
    assert len(rows) == 1 + 2 * 2 and rows[1].split(", ")[16:18] != rows[3].split(", ")[16:18]
    assert [r.split(", ")[17] for r in rows[1:]] == ["ft_xe"] * 2 + ["ft_sc"] * 2
    roles = sorted(os.listdir(workdir / "checkpoints"))
    assert roles == ["best_test", "best_valid", "ft_sc", "ft_xe", "last"]
    last = ckpt.restore_checkpoint(str(workdir), "last")
    assert last["epoch"] == 1 and last["global_steps"] == state.global_steps
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert state.model.cap_generator._dtype() is torch.float32   # the config's default
    assert (workdir / "tensorboard" / "scalars.jsonl").exists()

    resumed = main(overrides + ["exp.resume=true", "optimizer.finetune_sc_epochs=2"])
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "Train: epoch=2, phase=ft_sc" in out
    assert "Start self-critical optimization" not in out and "epoch=1," not in out
    assert len((workdir / "result.csv").read_text().splitlines()) == 1 + 3 * 2
    assert ckpt.restore_checkpoint(str(workdir), "last")["epoch"] == 2
    steps = {int(s["step"]) for s in resumed.optimizer.state.values()}
    assert max(steps) > max(int(s["step"]) for s in last["optimizer"]["state"].values())
