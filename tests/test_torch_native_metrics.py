"""The port's native metric library (``grit_tpu_torch.native``) on the CPU.

Its PTB tokenizer against the port's pure-Python one and the JAX package's
native one, string for string; its CIDEr-D against the port's pure-Python
scorer to 1e-10 relative (double sums in another order), with and without a
precomputed corpus, on the fixtures of tests/test_native_metrics.py and
tests/test_torch_trainer.py and on a synthetic corpus; ``Cider`` and
``PTBTokenizer`` taking it by default; where it is built, that several
processes may build it at once, and that a failed build raises.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from grit_tpu_torch import native
from grit_tpu_torch.data.metrics import Cider, PTBTokenizer
from grit_tpu_torch.data.tokenizer import ptb_tokenize_str
from test_native_metrics import GTS as NATIVE_GTS, RAW, RES as NATIVE_RES
from test_torch_trainer import GEN as TRAINER_GEN, GTS as TRAINER_GTS

REPO = Path(__file__).resolve().parent.parent
WORDS = ("a the A man's dog doesn't run, very fast. two dogs -- playing in 3 parks... "
         "it's red; 1,000 trees! (big) \"cat\" t-shirt on: under over").split()


def synthetic_corpus(n_images: int, seed: int = 0):
    """(gts, res): ``n_images`` images of five raw references and one raw
    candidate each, words (punctuation, contractions, numbers) from a seed."""
    rng = np.random.default_rng(seed)

    def caption():
        return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), rng.integers(1, 14)))

    gts = {i: [caption() for _ in range(5)] for i in range(n_images)}
    res = {i: [caption()] for i in range(n_images)}
    return gts, res


def test_native_tokenizer_equals_python_and_the_jax_package():
    from grit_tpu import native as jnative

    gts, _ = synthetic_corpus(200, seed=1)
    texts = RAW + [c for caps in gts.values() for c in caps] + ["", "A\nline break", "x--y"]
    got = native.ptb_tokenize_batch(texts)
    assert got == [ptb_tokenize_str(t) for t in texts]
    assert jnative.available()
    assert got == jnative.ptb_tokenize_batch(texts)
    # PTBTokenizer takes the library by default; both keep the corpus's shapes
    assert PTBTokenizer.tokenize(gts) == PTBTokenizer.tokenize(gts, use_native=False)
    assert PTBTokenizer.tokenize(RAW) == {i: [ptb_tokenize_str(t)] for i, t in enumerate(RAW)}
    assert PTBTokenizer.tokenize([]) == {} == PTBTokenizer.tokenize([], use_native=False)


def _fixture(name):
    if name == "native_metrics":
        return NATIVE_GTS, NATIVE_RES
    if name == "trainer":
        return TRAINER_GTS, TRAINER_GEN
    gts, res = synthetic_corpus(300, seed=2)
    return (PTBTokenizer.tokenize(gts, use_native=False),
            PTBTokenizer.tokenize(res, use_native=False))


@pytest.mark.parametrize("corpus", ["per_call", "precomputed"])
@pytest.mark.parametrize("fixture", ["native_metrics", "trainer", "synthetic"])
def test_native_cider_equals_python_cider(fixture, corpus):
    """NativeCider and ``Cider`` (native by default) against the pure-Python
    ``Cider(use_native=False)``: corpus score and every image's to 1e-10."""
    gts, res = _fixture(fixture)
    refs = gts if corpus == "precomputed" else None
    want = Cider(refs, use_native=False).compute_score(gts, res)
    for got in (native.NativeCider(corpus_refs=refs).compute_score(gts, res),
                Cider(refs).compute_score(gts, res)):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-10)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-10)
        assert got[1].shape == (len(gts),)
    assert want[0] > 0


def test_native_cider_equals_the_jax_packages_native_cider():
    """The same C++ source and flags: the JAX package's library gives the same
    scores bit for bit."""
    from grit_tpu.data.metrics import Cider as JCider

    gts, res = _fixture("synthetic")
    for refs in (None, gts):
        a, per_a = Cider(refs).compute_score(gts, res)
        b, per_b = JCider(refs).compute_score(gts, res)
        assert a == b and np.array_equal(per_a, per_b)


def test_native_library_is_built_in_the_ports_build_directory():
    """The library is the port's own source, built into grit_tpu_torch/_build
    under a name keyed by source and flags; nothing lands under grit_tpu/."""
    assert native.SOURCE == REPO / "grit_tpu_torch" / "native" / "fastmetrics.cpp"
    path = native.library_path()
    assert path.parent == REPO / "grit_tpu_torch" / "_build"
    assert path.name.startswith("libfastmetrics_") and path.suffix == ".so"
    lib = native.get_lib()
    assert Path(lib._name) == path and path.exists()
    assert not any(p.is_relative_to(REPO / "grit_tpu") for p in (path, Path(lib._name)))


def test_concurrent_builds_leave_one_library(tmp_path):
    """Three fresh processes build into one empty directory at once: each
    loads the library, and only the library is left there."""
    code = ("import sys; from pathlib import Path; from grit_tpu_torch import native\n"
            "native.BUILD_DIR = Path(sys.argv[1]); native.get_lib()\n"
            "print(native.library_path())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [proc.communicate(timeout=240) for proc in procs]
    assert [proc.returncode for proc in procs] == [0, 0, 0], [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1 and Path(paths.pop()).name == os.listdir(tmp_path)[0]
    assert len(os.listdir(tmp_path)) == 1


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed .*broken.cpp"):
        native.get_lib()
    assert not [p for p in (tmp_path / "_build").iterdir()]   # no temporary file left
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        Cider()
    assert Cider(use_native=False).compute_score(TRAINER_GTS, TRAINER_GEN)[0] > 0
