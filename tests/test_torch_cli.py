"""The port's evaluation CLIs and freezing-mode training against the JAX
package's, on the CPU, on tests/synth_coco.py's synthetic Karpathy dataset
with test_cli.py's tiny model (the feature-extraction tools are in
test_torch_extract.py, which shares the fixtures below).

Both packages run from the same weights: the port's seed-0 random captioner,
norms perturbed, saved in the port's ``torch.save`` layout for the port, as
an Orbax tree for JAX, and its detector as a reference detector ``.pth``.
Every port CLI runs with ``exp.device=cpu`` (or ``--device cpu``).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from test_cli import _assert_real_captions, tiny_overrides
from synth_coco import make_synth_coco

CPU = ["exp.device=cpu"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_coco")
    make_synth_coco(root)
    return root


@pytest.fixture(autouse=True)
def _env(data_root, monkeypatch, tmp_path):
    monkeypatch.setenv("DATA_ROOT", str(data_root))
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def checkpoints(data_root, tmp_path_factory):
    """(port checkpoint directory, Orbax directory, detector .pth) of one
    seed-0 tiny captioner."""
    os.environ["DATA_ROOT"] = str(data_root)
    import orbax.checkpoint as ocp

    from grit_tpu.convert import state_dict_to_params
    from grit_tpu_torch.engine import checkpoint as ckpt
    from grit_tpu_torch.engine.optim import build_optimizer
    from grit_tpu_torch.engine.xe import TrainState
    from grit_tpu_torch.eval_caption import caption_config
    from grit_tpu_torch.models.captioner import build_captioner

    root = tmp_path_factory.mktemp("torch_cli_ckpt")
    config = caption_config(tiny_overrides(data_root) + CPU)
    model = build_captioner(config, device="cpu", seed=0)
    with torch.no_grad():   # norms away from the identity, so their parameters matter
        g = torch.Generator().manual_seed(1)
        for mod in model.modules():
            if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                mod.weight.add_(torch.randn(mod.weight.shape, generator=g) * 0.3)
                mod.bias.add_(torch.randn(mod.bias.shape, generator=g) * 0.3)
    opt = build_optimizer(model, model_lr=1e-4, backbone_lr=1e-5)
    ckpt.save_checkpoint(str(root), "last", state=TrainState(model, opt, 0, None), epoch=0)
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    orbax_dir = root / "orbax_last"
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(str(orbax_dir), {"params": {"params": state_dict_to_params(sd)}})
    det_pth = root / "detector.pth"
    torch.save({"model": model.detector.state_dict()}, det_pth)
    return str(root / "checkpoints" / "last"), str(orbax_dir), str(det_pth)


def _scores(out: str) -> dict:
    """{split: [BLEU-1..4, METEOR, ROUGE, CIDEr]} from a CLI's printout."""
    found = {}
    for split in ("valid_dict", "test_dict"):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"{split}:"))
        scores = line[line.index("{"):line.rindex("}") + 1]
        found[split] = [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", scores)]
    return found


def test_eval_caption_scores_equal_jax(data_root, checkpoints, capsys):
    """The same fp32 weights, the port's checkpoint layout on one side and
    Orbax on the other: the same BLEU, METEOR, ROUGE and CIDEr."""
    import eval_caption as jax_cli

    from grit_tpu_torch import eval_caption

    port_dir, orbax_dir, _ = checkpoints
    eval_caption.main(tiny_overrides(data_root) + CPU + [f"exp.checkpoint={port_dir}"])
    ours = capsys.readouterr().out
    jax_cli.main(tiny_overrides(data_root) + [f"exp.checkpoint={orbax_dir}"])
    theirs = capsys.readouterr().out
    got, want = _scores(ours), _scores(theirs)
    for split in want:
        assert len(got[split]) == len(want[split]) >= 7, (ours, theirs)
        np.testing.assert_allclose(got[split], want[split], rtol=1e-12, err_msg=split)
    assert "load: missing" not in ours   # the port's own checkpoint holds every parameter


def test_eval_caption_online_writes_submission_jsons(data_root, checkpoints):
    from grit_tpu_torch import eval_caption_online

    eval_caption_online.main(tiny_overrides(data_root) + CPU
                             + [f"exp.checkpoint={checkpoints[0]}"])
    _assert_real_captions(json.load(open("result_test.json")), [501, 502, 503])
    _assert_real_captions(json.load(open("result_valid.json")), [11, 12, 13, 14])


def test_eval_nocaps_writes_results_json(data_root, checkpoints):
    from grit_tpu_torch import eval_nocaps

    eval_nocaps.main(["--checkpoint", checkpoints[0],
                      "--ann", str(data_root / "annotations" / "image_info_test2014.json"),
                      "--img-root", str(data_root / "test2014"), "--out", "nocaps_out.json",
                      "--batch", "2", "--device", "cpu"] + tiny_overrides(data_root))
    _assert_real_captions(json.load(open("nocaps_out.json")), [501, 502, 503])


def _same_batches(ours, theirs):
    assert len(ours) == len(theirs) > 1
    for (images, ids), (jimages, jmask, jids) in zip(ours, theirs):
        assert ids == jids
        np.testing.assert_array_equal(images.images.numpy(), jimages)
        np.testing.assert_array_equal(images.mask.numpy(), jmask)


def test_online_batches_equal_jax_composition(data_root):
    """minmax_resize(·, (384, 640)) -> to_normalized_array -> batch_images
    into the 640x640 bucket, as grit_tpu's eval_caption_online.py composes
    them, 16 images a batch (2 here)."""
    from PIL import Image

    from grit_tpu.data.transforms import minmax_resize, to_normalized_array
    from grit_tpu.utils.nested import batch_images
    from grit_tpu_torch.eval_caption_online import ONLINE_BUCKET, online_batches

    root = str(data_root / "val2014")
    images = json.load(open(data_root / "annotations" / "captions_val2014.json"))["images"]
    theirs = []
    for s in range(0, len(images), 2):
        arrs = []
        for info in images[s:s + 2]:
            with Image.open(os.path.join(root, info["file_name"])) as im:
                arrs.append(to_normalized_array(minmax_resize(im.convert("RGB"), (384, 640))))
        jb = batch_images(arrs, bucket_hw=(640, 640))
        theirs.append((np.asarray(jb.images), np.asarray(jb.mask),
                       [info["id"] for info in images[s:s + 2]]))
    ours = list(online_batches(images, root, batch=2))
    assert ONLINE_BUCKET == (640, 640) and ours[0][0].images.shape == (2, 640, 640, 3)
    assert ours[0][0].mask.any() and not ours[0][0].mask.all()
    _same_batches(ours, theirs)


def test_nocaps_batches_equal_jax_composition(data_root):
    import eval_nocaps as jax_cli

    from grit_tpu.data.transforms import get_transform as jax_transform
    from grit_tpu.utils.nested import batch_images
    from grit_tpu_torch.data.transforms import get_transform
    from grit_tpu_torch.eval_caption import caption_config
    from grit_tpu_torch.eval_nocaps import NocapsDataset, nocaps_batches

    cfg = caption_config(tiny_overrides(data_root)).dataset.transform_cfg
    ann = str(data_root / "annotations" / "image_info_test2014.json")
    root = str(data_root / "test2014")
    jds = jax_cli.NocapsDataset(ann, root, jax_transform(cfg)["valid"])
    theirs = []
    for s in range(0, len(jds), 2):
        items = [jds[i] for i in range(s, min(s + 2, len(jds)))]
        jb = batch_images([it[0] for it in items], bucket_hw=tuple(cfg.size))
        theirs.append((np.asarray(jb.images), np.asarray(jb.mask), [it[1] for it in items]))
    ours = list(nocaps_batches(NocapsDataset(ann, root, get_transform(cfg)["valid"]),
                               cfg.size, 2))
    _same_batches(ours, theirs)


def _h5(path) -> dict:
    import h5py

    with h5py.File(path) as f:
        return {k: f[k][:] for k in f}


def test_train_caption_freezing_mode_extracts_then_trains(data_root, tmp_path, capsys):
    """Freezing mode with the hdf5 absent (reference train_caption.py:48-59):
    the CLI extracts the features with the loaded detector weights, writes
    the file, and trains an epoch on it."""
    from grit_tpu_torch import train_caption

    h5 = tmp_path / "auto_feats.h5"
    train_caption.main(tiny_overrides(data_root) + CPU + [
        "exp.name=vauto", f"dataset.hdf5_path={h5}", "optimizer.freezing_xe_epochs=1",
        "optimizer.freezing_sc_epochs=0", "optimizer.finetune_xe_epochs=0",
        "optimizer.finetune_sc_epochs=0", "optimizer.batch_size=1"])
    out = capsys.readouterr().out
    assert "extracting features" in out
    feats = _h5(h5)
    assert sorted(feats["image_ids"].tolist()) == [1, 2, 11, 12, 13, 14]
    assert feats["gri_feat"].dtype == np.float16
    rows = [ln for ln in open("outputs/vauto/result.csv") if ln.startswith("vauto")]
    assert len(rows) == 2, rows   # the valid and test evaluation of the freezing epoch
