"""ctypes binding of the native metric library (``fastmetrics.cpp``).

``ptb_tokenize_batch`` and ``NativeCider`` are the C++ counterparts of the
pure-Python ``data.tokenizer.ptb_tokenize_str`` and ``data.metrics.Cider``
(the same tokens, and CIDEr-D to 1e-10), which the reference computes with
Java subprocesses and Python dictionaries.  ``PTBTokenizer`` and ``Cider``
take them by default: SCST tokenizes and scores every training batch on the
host, and the trainer computes the whole training corpus's document
frequencies at start-up.

The library is built with g++ at first use from this package's own source
into ``grit_tpu_torch/_build/`` (git-ignored), under a name keyed by a hash of
the source and the flags, so an edited source rebuilds.  Several processes may
build it at once (test workers, data-parallel ranks): each compiles into a
file of its own and moves it into place with ``os.replace``.  ``get_lib``
raises on a failed build, with the compiler's output.  ``available()`` is what
``Cider`` and ``PTBTokenizer`` ask, as grit_tpu's do: when g++ is missing or
the build fails they score with their pure-Python versions, and one warning a
process names the cause (g++ not found, or g++'s exit code and the first lines
of its output); the failure is remembered, not retried.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid
import warnings
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastmetrics.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()
#: why the library could not be built or loaded in this process, once known
_failure: str | None = None
#: lines of the compiler's output that the fallback's warning quotes
WARN_LINES = 5


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastmetrics_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native metric library needs a C++ compiler "
                           "(or pass use_native=False for the pure-Python path)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building {SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> ctypes.CDLL:
    """The native library, built on first call (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.fm_ptb_tokenize.restype = ctypes.c_void_p
        lib.fm_ptb_tokenize.argtypes = [ctypes.c_char_p]
        lib.fm_free.restype = None
        lib.fm_free.argtypes = [ctypes.c_void_p]
        lib.fm_cider_corpus_new.restype = ctypes.c_void_p
        lib.fm_cider_corpus_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                                            ctypes.c_int32]
        lib.fm_cider_corpus_free.restype = None
        lib.fm_cider_corpus_free.argtypes = [ctypes.c_void_p]
        lib.fm_cider_scores.restype = None
        lib.fm_cider_scores.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here.  On the first failure it
    warns once, naming the cause, and from then on answers False without
    building again; ``Cider`` and ``PTBTokenizer`` then score in Python."""
    global _failure
    if _failure is not None:
        return False
    try:
        get_lib()
        return True
    except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
        _failure = "\n".join(str(exc).splitlines()[:WARN_LINES])
        warnings.warn(f"grit_tpu_torch.native: the metric library is unavailable "
                      f"({_failure}); scoring with the pure-Python tokenizer and CIDEr-D",
                      RuntimeWarning, stacklevel=2)
        return False


def ptb_tokenize_batch(captions: list[str]) -> list[str]:
    """PTB-tokenize a batch of captions -> space-joined token strings, one a
    caption (as ``ptb_tokenize_str``)."""
    lib = get_lib()
    joined = "\n".join(c.replace("\n", " ") for c in captions).encode()
    ptr = lib.fm_ptb_tokenize(joined)
    try:
        out = ctypes.string_at(ptr).decode()
    finally:
        lib.fm_free(ptr)
    return out.split("\n")


def _pack_refs(grouped: list[list[str]]):
    """Newline-joined references and each group's [start, end) offsets."""
    lines, offsets = [], [0]
    for refs in grouped:
        lines += [r.replace("\n", " ") for r in refs]
        offsets.append(len(lines))
    return "\n".join(lines).encode(), (ctypes.c_int32 * len(offsets))(*offsets)


class NativeCider:
    """CIDEr-D over pre-tokenized strings, as ``data.metrics.Cider``: with
    ``corpus_refs`` (id -> list of references) the document frequencies are
    those of that corpus, computed once; without, those of the references
    each call scores."""

    def __init__(self, corpus_refs: dict | None = None, sigma: float = 6.0):
        self.sigma = sigma
        self._lib = get_lib()
        self._handle = None
        if corpus_refs is not None:
            joined, offsets = _pack_refs(list(corpus_refs.values()))
            self._handle = self._lib.fm_cider_corpus_new(joined, offsets, len(corpus_refs))

    def compute_score(self, gts: dict, res: dict):
        """gts: id -> list of refs; res: id -> [candidate] -> (corpus, per-image)."""
        if gts.keys() != res.keys():
            raise ValueError("compute_score: gts and res must have the same keys")
        keys = list(gts)
        cands = "\n".join(res[k][0].replace("\n", " ") for k in keys).encode()
        joined, offsets = _pack_refs([gts[k] for k in keys])
        scores = (ctypes.c_double * len(keys))()
        self._lib.fm_cider_scores(self._handle, cands, joined, offsets, len(keys),
                                  ctypes.c_double(self.sigma), scores)
        arr = np.asarray(list(scores))
        return float(arr.mean()), arr

    def close(self) -> None:
        """Free the precomputed corpus (also on garbage collection)."""
        if self._handle is not None:
            self._lib.fm_cider_corpus_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self.close()

    def __str__(self):
        return "CIDEr"
