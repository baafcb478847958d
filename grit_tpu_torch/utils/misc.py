"""Host-side helpers of the trainers and the measuring tools (own copy of
what the port uses of grit_tpu/utils/misc.py: the host RNG seeding, and the
device-memory, trace-span and profiler-trace helpers of :165-194 on torch; the
detector solver logs through its hooks and uses neither ``SmoothedValue`` nor
``MetricLogger``)."""

from __future__ import annotations

import contextlib
import os
import random
import re

import numpy as np
import torch


def seed_host_rngs(seed: int, *, rank: int = 0) -> None:
    """Seed the host-side RNGs (python ``random`` and ``np.random``) that the
    augmentation pipelines draw from, ``seed + rank`` as the reference's
    start-up seeding does (train_detector.py:116-120).  Device randomness goes
    through explicit ``torch.Generator``s."""
    seed = seed + rank
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))


def device_memory_mb(device=None) -> float | None:
    """Peak device memory allocated by this process on ``device`` (default:
    the current card) since the last ``torch.cuda.reset_peak_memory_stats``,
    in MB; None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated(device) / 1e6


_NO_SPAN = contextlib.nullcontext()


def trace_annotation(name: str):
    """The port's one span helper: a ``with`` context that, while
    torch.profiler records, opens ``record_function(name)``, a
    ``user_annotation`` event on the profiler's own timeline (the clock of
    its kernel and memcpy records), kept by the profiler and written out with
    its trace.  While it does not record, a shared no-op context: one
    attribute read, no ``record_function``.  The port's spans are named
    ``grit.*`` and each is read by a metric of the benchmark."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def start_profiler_trace(logdir: str, device: str = "cuda"):
    """Start a torch.profiler trace of the host and, on ``"cuda"``, of the
    card -> the profiler, for ``stop_profiler_trace``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.logdir = logdir
    prof.start()
    return prof


def stop_profiler_trace(prof, name: str = "trace") -> str:
    """Stop ``prof`` (``start_profiler_trace``'s) and write its chrome trace
    into its directory as ``<name>_<pid>.json`` -> the file's path."""
    prof.stop()
    os.makedirs(prof.logdir, exist_ok=True)
    stem = re.sub(r"[^A-Za-z0-9_.=-]+", "_", name)
    path = os.path.join(prof.logdir, f"{stem}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
