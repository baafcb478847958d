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
    jaxlib loaded next to the port would preallocate the card)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import grit_tpu_torch\n"
        "for m in pkgutil.walk_packages(grit_tpu_torch.__path__, 'grit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import grit_tpu_torch.inference_caption, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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

    from grit_tpu.config import default_caption_config
    from grit_tpu.data.vocab import Vocab
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
    torch.save({"state_dict": build_captioner(config, seed=0).state_dict()}, ckpt)
    img = tmp_path / "img.png"
    rng = np.random.default_rng(11)
    Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)).save(img)
    main(["--image", str(img), "--checkpoint", str(ckpt), "--vocab", str(vocab_path),
          "--device", "cpu", "--beam", "2", *overrides])
    caption = capsys.readouterr().out.strip()
    assert caption.startswith("Caption:")
    assert all(w in vocab for w in caption[len("Caption:"):].split())
