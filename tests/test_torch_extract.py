"""The port's feature-extraction tools against the JAX package's, on the
CPU, on tests/synth_coco.py's synthetic Karpathy dataset with test_cli.py's
tiny model and the detector weights of test_torch_cli.py's fixture: the same
hdf5 datasets, shapes, dtypes, ids and paths, and bf16 features held to the
JAX detector's fp32 output within 1.5x the JAX package's own bf16 error (the
rule of test_torch_slice.py::test_compute_vis_bf16_as_precise_as_jax).
"""

import json
import os

import numpy as np
import pytest

from test_cli import tiny_overrides
from test_torch_cli import CPU, _env, _h5, checkpoints, data_root  # noqa: F401


def _rms_rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(((a - ref) ** 2).mean() / (ref ** 2).mean())


@pytest.fixture(scope="module")
def jax_f32_features(data_root, checkpoints, tmp_path_factory):
    """The JAX detector's fp32 features of every image, by image id, from the
    JAX package's extraction loop with an fp32 detector."""
    import jax

    from grit_tpu.config import default_caption_config
    from grit_tpu.convert import load_detector_checkpoint
    from grit_tpu.data.coco import build_coco_dataloaders
    from grit_tpu.models.detector import build_detector
    from grit_tpu.utils.nested import ImageBatch
    from tools.extract_features import extract_vis_features

    os.environ["DATA_ROOT"] = str(data_root)
    config = default_caption_config().apply_overrides(tiny_overrides(data_root))
    detector = build_detector(config)
    h, w = config.dataset.transform_cfg.size
    params = detector.init(jax.random.PRNGKey(0), ImageBatch(np.zeros((1, h, w, 3), np.float32),
                                                             np.zeros((1, h, w), bool)))
    loaded = load_detector_checkpoint(checkpoints[2])["params"]
    assert set(loaded) == set(params["params"])
    path = str(tmp_path_factory.mktemp("jax_f32") / "f32.h5")
    loaders, _ = build_coco_dataloaders(config, mode="finetune")
    extract_vis_features(jax.jit(detector.apply), {"params": loaded}, config, loaders, path)
    ref = _h5(path)
    return {int(i): {k: ref[k][n] for k in ("gri_feat", "reg_feat")}
            for n, i in enumerate(ref["image_ids"])}


def _held_to_f32(ours: dict, theirs: dict, ref: dict) -> None:
    """Each bf16 feature within 1.5x the JAX package's own bf16 error of the
    JAX detector's fp32 output (relative RMS error)."""
    for k in ("gri_feat", "reg_feat"):
        r = np.stack([ref[int(i)][k] for i in ours["image_ids"]])
        port, jax_err = _rms_rel(ours[k], r), _rms_rel(theirs[k], r)
        assert 0 < port <= 1.5 * jax_err, f"{k}: port bf16 rms err {port:.3e}, jax {jax_err:.3e}"


def _same_layout(ours: dict, theirs: dict) -> None:
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape and ours[k].dtype == theirs[k].dtype, k
    for k in ("image_ids", "gri_mask", "reg_mask"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert ours["gri_feat"].dtype == np.float16 and ours["gri_mask"].dtype == bool


def test_extract_features_matches_jax(data_root, checkpoints, jax_f32_features, tmp_path):
    import tools.extract_features as jax_tool

    from grit_tpu_torch.tools import extract_features

    args = tiny_overrides(data_root) + [f"model.detector.checkpoint={checkpoints[2]}"]
    extract_features.main(args + CPU + [f"dataset.hdf5_path={tmp_path / 'ours.h5'}"])
    jax_tool.main(args + [f"dataset.hdf5_path={tmp_path / 'theirs.h5'}"])
    ours, theirs = _h5(tmp_path / "ours.h5"), _h5(tmp_path / "theirs.h5")
    _same_layout(ours, theirs)
    assert sorted(ours["image_ids"].tolist()) == [1, 2, 11, 12, 13, 14]
    assert ours["reg_feat"].shape[:2] == (6, 6)
    _held_to_f32(ours, theirs, jax_f32_features)


def test_artemis_extract_features_matches_jax(data_root, checkpoints, jax_f32_features,
                                              tmp_path):
    import tools.artemis_extract_features as jax_tool

    from grit_tpu_torch.tools import artemis_extract_features

    listing = tmp_path / "paintings.json"
    paths = sorted(p.name for p in (data_root / "val2014").iterdir())[:3]
    json.dump(paths, open(listing, "w"))
    args = ["--listing", str(listing), "--img-root", str(data_root / "val2014"),
            "--checkpoint", checkpoints[2], "--batch", "2"] + tiny_overrides(data_root)
    artemis_extract_features.main(args + ["--out", str(tmp_path / "ours.h5"), "--device", "cpu"])
    jax_tool.main(args + ["--out", str(tmp_path / "theirs.h5")])
    ours, theirs = _h5(tmp_path / "ours.h5"), _h5(tmp_path / "theirs.h5")
    _same_layout(ours, theirs)
    np.testing.assert_array_equal(ours["paths"], theirs["paths"])
    assert [p.decode() for p in ours["paths"]] == paths
    # row i is image i of the listing, whose COCO id the file name carries
    by_id = {n: jax_f32_features[int(p[-8:-4])] for n, p in enumerate(paths)}
    _held_to_f32(ours, theirs, by_id)
