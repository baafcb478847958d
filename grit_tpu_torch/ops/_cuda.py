"""Build and load the hand-written Hopper kernels (``grit_tpu_torch/csrc``).

The CUDA sources compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` a source,
all started together, and link into one shared library with a plain C
interface, loaded through ``ctypes``.  The build runs at first use,
from the package's own sources, into ``grit_tpu_torch/_build/`` (git-ignored),
keyed by a hash of the sources and flags, so a fresh checkout builds itself
and an edited source rebuilds.  Nothing here runs at import time: the CPU
tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the exported launchers (every one returns cudaGetLastError)
_SIGNATURES = {
    "grit_ln_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "grit_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _P],
    "grit_window_attn": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "grit_window_attn_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    "grit_window_attn_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "grit_window_attn_dense_bwd": [_P] * 9 + [_I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "grit_ln_linear": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "grit_ln_merge": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "grit_msda": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "grit_msda_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _P],
    "grit_adam": [_P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P],
    "grit_decode_tail": [_P] * 12 + [_I] * 9 + [_F, _I, _P],
    "grit_lsa": [_P, _P, _P, _I, _I, _I, _P],
}


_lib = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _code_flags() -> list[str]:
    """NVCC_FLAGS without ``-Xptxas -v``, which changes what ptxas prints and
    not the code: a library built with it serves a process without it (the
    ranks of a data-parallel run load the library their parent built)."""
    out, i = [], 0
    while i < len(NVCC_FLAGS):
        if NVCC_FLAGS[i:i + 2] == ["-Xptxas", "-v"]:
            i += 2
        else:
            out.append(NVCC_FLAGS[i])
            i += 1
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def _build(srcs: list[Path], out: Path) -> None:
    """Compile each ``.cu`` to an object in its own ``nvcc`` (all at once),
    then link them.  Each compiler's messages go to ``<source>.log`` beside
    the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in (p for p in srcs if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        log = open(BUILD_DIR / f"{src.stem}.log", "w")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((src, obj, log, proc))
    failed = []
    for src, _, log, proc in jobs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n"
                          f"{(BUILD_DIR / f'{src.stem}.log').read_text()}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *[str(obj) for _, obj, _, _ in jobs]],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr}")
    for _, obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(_code_flags()).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libgrit_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build(srcs, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def require(t: torch.Tensor, name: str, dtype=None, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype/shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
