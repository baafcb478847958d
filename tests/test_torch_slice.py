"""The port's slice end to end against the JAX package, on the CPU at fp32:
uint8 images -> compute_vis -> beam search captions, through each package's
``engine.evaluator.make_caption_generator``, plus the precision of the bf16
features, the port's import hygiene and its inference CLI's refusal to fall
back to the CPU.

Captions must match token for token.  A difference is accepted only at a
near-tie: at the first differing step, the port's decision margin (the
smallest gap between adjacent candidates among the top beam+1) must be
<= 1e-3, the rule chip_smoke.py applies on the card.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (BOS, VOCAB, assert_close, jax_captioner, jax_params,
                               torch_captioner, torch_one_thread, uint8_images)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEAM, STEPS = 3, 8
NEAR_TIE = 1e-3


@pytest.fixture(scope="module")
def slice_twins():
    from grit_tpu.utils.nested import ImageBatch as JaxBatch
    from grit_tpu_torch.utils.nested import ImageBatch

    model = torch_captioner()
    imgs, mask = uint8_images()
    return (model, jax_captioner(), {"params": jax_params(model)},
            ImageBatch(torch.from_numpy(imgs), torch.from_numpy(mask)),
            JaxBatch(jnp.asarray(imgs), jnp.asarray(mask)))


def _jax_vis(jmodel, params, jbatch):
    return jax.jit(lambda p, b: jmodel.apply(p, b, method="compute_vis"))(params, jbatch)


@pytest.fixture(scope="module")
def jax_vis_f32(slice_twins):
    _, jmodel, params, _, jbatch = slice_twins
    return _jax_vis(jmodel, params, jbatch)


def test_compute_vis_matches_jax(slice_twins, jax_vis_f32):
    model, _, _, batch, _ = slice_twins
    with torch.no_grad():
        out = model.compute_vis(batch)
    for k in ("gri_feat", "gri_mask", "reg_feat", "reg_mask"):
        assert_close(out[k].numpy(), jax_vis_f32[k], scale=True)


def test_compute_vis_bf16_as_precise_as_jax(slice_twins, jax_vis_f32):
    """bf16 compute against the JAX package's f32 result: the port's
    relative RMS error stays within 1.5x the JAX package's own bf16 error on
    the same weights (measured: 1.20x for gri_feat, where the two round
    activations at different points, and 0.66x for reg_feat, whose reference
    boxes the port keeps f32).  This catches a lost f32 statistic or
    accumulation, not parameter storage: rounding the f32 parameters to bf16
    moves the ratios only to 1.34x and 0.79x, within bf16's own noise, so
    test_compute_dtype_casts_only_linear_and_conv pins that."""
    import copy

    from grit_tpu_torch.models.captioner import to_compute_dtype

    model, _, params, batch, jbatch = slice_twins
    ref = {k: np.asarray(jax_vis_f32[k], np.float64) for k in ("gri_feat", "reg_feat")}
    jout = _jax_vis(jax_captioner(jnp.bfloat16), params, jbatch)
    with torch.no_grad():
        out = to_compute_dtype(copy.deepcopy(model), torch.bfloat16).compute_vis(batch)
    for k, r in ref.items():
        assert out[k].dtype == torch.bfloat16

        def rms_err(a):
            return np.sqrt(((np.asarray(a, np.float64) - r) ** 2).mean() / (r ** 2).mean())

        port, jax_err = rms_err(out[k].float().numpy()), rms_err(np.asarray(jout[k], np.float32))
        assert 0 < port <= 1.5 * jax_err, f"{k}: port bf16 rms err {port:.3e}, jax {jax_err:.3e}"


def _margins(model, batch, eos):
    from grit_tpu_torch.decoding.beam_search import beam_search

    with torch.no_grad():
        vis = model.compute_vis(batch)
        kv = model.precompute_vis_kv(vis)
        res = beam_search(
            lambda tok, t, v, c: model.decode_step(tok, t, v, c, vis_kv=kv, vis_fold=BEAM),
            model.init_cache(2 * BEAM, STEPS), vis, 2, BEAM, STEPS, BOS, eos,
            return_margins=True)
    return res.margins.numpy()


@pytest.mark.parametrize("eos_kind", ["unused", "early"])
def test_captions_match_jax(slice_twins, eos_kind):
    """``unused``: EOS is no vocabulary id, so every beam runs all steps;
    ``early``: EOS is the port's first chosen token, so beams freeze."""
    from grit_tpu.engine.evaluator import make_caption_generator as jax_generator
    from grit_tpu_torch.engine.evaluator import make_caption_generator

    model, jmodel, params, batch, jbatch = slice_twins
    gen = make_caption_generator(model, beam_size=BEAM, max_len=STEPS, bos_idx=BOS,
                                 eos_idx=VOCAB)
    eos = VOCAB
    if eos_kind == "early":
        eos = int(gen(batch, 2)[0, 0])
        gen = make_caption_generator(model, beam_size=BEAM, max_len=STEPS, bos_idx=BOS,
                                     eos_idx=eos)
    out = gen(batch, 2).numpy()
    ref = np.asarray(jax_generator(jmodel, beam_size=BEAM, max_len=STEPS, bos_idx=BOS,
                                   eos_idx=eos)(params, jbatch, 2))
    assert out.shape == ref.shape == (2, STEPS)
    if eos_kind == "early":
        assert (out == eos).any()
    for i in np.nonzero((out != ref).any(1))[0]:
        step = int(np.argmax(out[i] != ref[i]))
        margin = float(_margins(model, batch, eos)[i, step])
        assert margin <= NEAR_TIE, (
            f"image {i}: captions differ from step {step} with decision margin {margin:.3e}")


def test_port_imports_no_jax():
    """Every port module, its CLI and chip_smoke import without JAX (a CUDA
    jaxlib loaded next to the port would preallocate the card) and without
    any module of the JAX package, in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import grit_tpu_torch\n"
        "for m in pkgutil.walk_packages(grit_tpu_torch.__path__, 'grit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import grit_tpu_torch.inference_caption, grit_tpu_torch.train_caption, chip_smoke\n"
        "import grit_tpu_torch.train_detector\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'grit_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'grit_tpu_torch.engine.xe' in sys.modules\n"
        "for m in ('engine.scst', 'engine.loops', 'engine.checkpoint', 'engine.logger',\n"
        "          'data.coco', 'data.metrics.cider', 'ops.decode_layer', 'ops.fused_adam',\n"
        "          'detection.detector', 'detection.losses', 'detection.postprocess',\n"
        "          'detection.solver', 'detection.hooks', 'detection.loader',\n"
        "          'detection.datasets', 'detection.det_transforms', 'detection.coco_eval',\n"
        "          'utils.boxes', 'utils.misc', 'train_detector', 'eval_caption',\n"
        "          'eval_caption_online', 'eval_nocaps', 'models.ensemble',\n"
        "          'tools.extract_features', 'tools.artemis_extract_features',\n"
        "          'parallel', 'parallel.distributed', 'parallel.mesh', 'dryrun',\n"
        "          'native', 'ops.lsa', 'tools.bench_train', 'tools.profile_eval',\n"
        "          'tools.agg_trace', 'tools.bench_epoch', 'tools.timing'):\n"
        "    assert 'grit_tpu_torch.' + m in sys.modules, m\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_no_image_or_checkpoint_library():
    """chip_smoke.py runs where PIL, h5py and orbax may be missing: importing
    it (and with it the trainer's engine modules and the metric suite) loads
    none of them, nor JAX."""
    code = ("import sys, chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'h5py', 'orbax', 'jax', 'jaxlib', 'grit_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'grit_tpu_torch.engine.scst' in sys.modules\n"
            "assert 'grit_tpu_torch.detection.solver' in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_import_no_image_or_hdf5_library():
    """The evaluation CLIs, the feature-extraction tools, the ensemble and the
    trainer import PIL and h5py inside the functions that read images or
    write hdf5 (the card's machine may lack both): importing them loads
    neither, nor JAX."""
    code = ("import sys\n"
            "import grit_tpu_torch.eval_caption, grit_tpu_torch.eval_caption_online\n"
            "import grit_tpu_torch.eval_nocaps, grit_tpu_torch.models.ensemble\n"
            "import grit_tpu_torch.tools.extract_features\n"
            "import grit_tpu_torch.tools.artemis_extract_features\n"
            "import grit_tpu_torch.train_caption, grit_tpu_torch.decoding.beam_search\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'h5py', 'jax', 'jaxlib', 'grit_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax_package_module():
    """An import inside a function body is invisible to the check above, so
    the sources are scanned too: no file of the port, nor chip_smoke.py,
    imports ``jax`` or the JAX package."""
    import re
    from pathlib import Path

    pattern = re.compile(r"^\s*(import\s+(grit_tpu|jax|flax|optax)(\s|\.|,|$)"
                         r"|from\s+(grit_tpu|jax|flax|optax)(\.\S+)?\s+import)", re.M)
    files = sorted(f for f in Path(REPO, "grit_tpu_torch").rglob("*.py")
                   if "_build" not in f.parts) + [Path(REPO, "chip_smoke.py")]   # build outputs
    assert len(files) > 58 and Path(REPO, "grit_tpu_torch", "train_caption.py") in files
    assert Path(REPO, "grit_tpu_torch", "train_detector.py") in files
    assert Path(REPO, "grit_tpu_torch", "detection", "losses.py") in files
    for part in (("parallel", "__init__.py"), ("parallel", "distributed.py"),
                 ("parallel", "mesh.py"), ("dryrun.py",), ("native", "__init__.py"),
                 ("ops", "lsa.py"), ("tools", "bench_train.py"), ("tools", "profile_eval.py"),
                 ("tools", "agg_trace.py"), ("tools", "bench_epoch.py"), ("tools", "timing.py")):
        assert Path(REPO, "grit_tpu_torch", *part) in files
    bad = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert not bad, bad
    assert pattern.search("    from grit_tpu.config import x") and pattern.search("import jax")
    assert not pattern.search("from grit_tpu_torch.config import x\nimport grit_tpu_torch")


def test_port_config_equals_jax_config():
    """The port's own config tree has the JAX package's keys and defaults,
    caption and detection, key for key."""
    from grit_tpu import config as jconfig
    from grit_tpu_torch import config as tconfig

    for name in ("default_caption_config", "default_detection_config"):
        a, b = getattr(tconfig, name)().to_dict(), getattr(jconfig, name)().to_dict()

        def walk(x, y, path=""):
            assert type(x) is type(y), path
            if isinstance(x, dict):
                assert list(x) == list(y), path
                for k in x:
                    walk(x[k], y[k], f"{path}.{k}")
            else:
                assert x == y, path

        walk(a, b)
    cfg = tconfig.default_caption_config().apply_overrides(["model.d_model=64"])
    assert cfg.model.d_model == 64 and cfg.optimizer.batch_size == 16


CAPTIONS = ["A man's t-shirt isn't red, it's blue!", "Two dogs (3.5 kg each) -- running...",
            "THE cat; the hat: they're on a well-known mat?\n", "a"]


def _data_transforms(jdata, tdata, tmp_path):
    """Every resize family, with host and with device normalisation, on an
    RGB and a grey image: equal arrays, bit for bit; RandAugment draws the
    same ops from the same ``random`` seed."""
    import random
    from types import SimpleNamespace

    from PIL import Image

    rng = np.random.default_rng(5)
    images = [Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)),
              Image.fromarray(rng.integers(0, 256, (90, 40), dtype=np.uint8))]
    for resize_name, size in (("maxwh", (64, 96)), ("minmax", (64, 128)), ("normal", (32, 48))):
        for device_norm in (False, True):
            for randaug in (False, True):
                cfg = SimpleNamespace(size=size, resize_name=resize_name, randaug=randaug,
                                      device_norm=device_norm)
                ours, theirs = tdata.transforms.get_transform(cfg), jdata.transforms.get_transform(cfg)
                for img in images:
                    for split in ("train", "valid"):
                        random.seed(3)
                        a = ours[split](img)
                        random.seed(3)
                        b = theirs[split](img)
                        assert a.dtype == b.dtype == (np.uint8 if device_norm else np.float32)
                        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdata.transforms.MEAN, jdata.transforms.MEAN)
    np.testing.assert_array_equal(tdata.transforms.STD, jdata.transforms.STD)


def _data_tokenizer(jdata, tdata, tmp_path):
    for cap in CAPTIONS:
        for lower in (True, False):
            for remove_punct in (True, False):
                assert (tdata.tokenizer.caption_tokenize(cap, lower, remove_punct)
                        == jdata.tokenizer.caption_tokenize(cap, lower, remove_punct))
        assert tdata.tokenizer.ptb_tokenize_str(cap) == jdata.tokenizer.ptb_tokenize_str(cap)
    assert (tdata.tokenizer.PTBTokenizer.tokenize({7: CAPTIONS, 9: CAPTIONS[:1]})
            == jdata.tokenizer.PTBTokenizer.tokenize({7: CAPTIONS, 9: CAPTIONS[:1]}))
    assert (tdata.tokenizer.PTBTokenizer.tokenize(CAPTIONS)
            == jdata.tokenizer.PTBTokenizer.tokenize(CAPTIONS))


def _counter(tdata):
    from collections import Counter

    return Counter(t for cap in CAPTIONS * 2 + CAPTIONS[:2]
                   for t in tdata.tokenizer.caption_tokenize(cap))


def _data_vocab(jdata, tdata, tmp_path):
    """Built from the same counter (ties, a frequency floor, a size cap), and
    saved by one package and loaded by the other."""
    counter = _counter(tdata)
    for kw in ({}, {"min_freq": 3}, {"max_size": 5}):
        ours, theirs = tdata.vocab.Vocab(counter=counter, **kw), jdata.vocab.Vocab(counter=counter, **kw)
        assert ours.itos == theirs.itos and ours.freqs == theirs.freqs and len(ours) == len(theirs)
        for tok in list(counter) + ["<pad>", "never-seen"]:
            assert ours.stoi(tok) == theirs.stoi(tok) and (tok in ours) == (tok in theirs)
    ours.save(str(tmp_path / "ours.json"))
    theirs.save(str(tmp_path / "theirs.json"))
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()
    assert jdata.vocab.Vocab(vocab_path=str(tmp_path / "ours.json")).itos == ours.itos
    assert tdata.vocab.Vocab(vocab_path=str(tmp_path / "theirs.json")).itos == theirs.itos
    assert tdata.vocab.SPECIALS == jdata.vocab.SPECIALS


def _data_field(jdata, tdata, tmp_path):
    """preprocess -> pad -> ids, to the batch's longest caption and to a fixed
    length, and back to words."""
    counter = _counter(tdata)
    for fix_length in (None, 6):
        ours = tdata.field.TextField(vocab=tdata.vocab.Vocab(counter=counter, min_freq=3),
                                     fix_length=fix_length)
        theirs = jdata.field.TextField(vocab=jdata.vocab.Vocab(counter=counter, min_freq=3),
                                       fix_length=fix_length)
        toks = [ours.preprocess(c) for c in CAPTIONS]
        assert toks == [theirs.preprocess(c) for c in CAPTIONS]
        assert ours.pad(toks) == theirs.pad(toks)
        ids = ours.process(toks)
        assert ids.dtype == theirs.process(toks).dtype
        np.testing.assert_array_equal(ids, theirs.process(toks))
        assert (ids == 0).any() and (ids == 1).any()      # an <unk> and a <pad> are exercised
        for join in (True, False):
            assert ours.decode(ids, join) == theirs.decode(ids, join)
        assert ours.decode(ids[0]) == theirs.decode(ids[0])
        assert ours.decode(ids[None]) == theirs.decode(ids[None])


@pytest.mark.parametrize("check", [_data_transforms, _data_tokenizer, _data_vocab, _data_field],
                         ids=["transforms", "tokenizer", "vocab", "field"])
def test_port_data_modules_match_jax_package(check, tmp_path):
    """The port's own copies of the JAX package's jax-free data modules give
    the same output on the same image, captions and word counts, exactly."""
    import importlib

    jdata, tdata = (type("ns", (), {m: importlib.import_module(f"{pkg}.data.{m}")
                                    for m in ("transforms", "tokenizer", "vocab", "field")})
                    for pkg in ("grit_tpu", "grit_tpu_torch"))
    check(jdata, tdata, tmp_path)


def test_inference_cli_refuses_missing_cuda():
    from grit_tpu_torch.inference_caption import caption_image

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        caption_image("unused.jpg", "unused.pth", device="cuda")


def test_inference_cli_captions_an_image(tmp_path, capsys):
    """python -m grit_tpu_torch.inference_caption end to end on a tiny config:
    image -> transform -> reference-format .pth (strict load) -> caption."""
    from collections import Counter

    from PIL import Image

    from grit_tpu_torch.config import default_caption_config
    from grit_tpu_torch.data.vocab import Vocab
    from grit_tpu_torch.inference_caption import main
    from grit_tpu_torch.models.captioner import build_captioner

    vocab = Vocab(counter=Counter({f"w{i}": 5 for i in range(16)}))
    vocab_path = tmp_path / "vocab.json"
    vocab.save(str(vocab_path))
    overrides = ["model.backbone=swin_test", "model.grid_feat_dim=64",
                 "model.detector.num_levels=2", "model.vocab_size=20",
                 "model.beam_len=4", "dataset.transform_cfg.size=[64, 96]"]
    config = default_caption_config().apply_overrides(overrides)
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"state_dict": build_captioner(config, device="cpu", seed=0).state_dict()}, ckpt)
    img = tmp_path / "img.png"
    rng = np.random.default_rng(11)
    Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)).save(img)
    main(["--image", str(img), "--checkpoint", str(ckpt), "--vocab", str(vocab_path),
          "--device", "cpu", "--beam", "2", *overrides])
    caption = capsys.readouterr().out.strip()
    assert caption.startswith("Caption:")
    assert all(w in vocab for w in caption[len("Caption:"):].split())
