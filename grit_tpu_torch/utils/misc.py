"""Host-side helpers of the trainers (own copy of what the port uses of
grit_tpu/utils/misc.py: the host RNG seeding; the detector solver logs
through its hooks and uses neither ``SmoothedValue`` nor ``MetricLogger``)."""

from __future__ import annotations

import random

import numpy as np


def seed_host_rngs(seed: int, *, rank: int = 0) -> None:
    """Seed the host-side RNGs (python ``random`` and ``np.random``) that the
    augmentation pipelines draw from, ``seed + rank`` as the reference's
    start-up seeding does (train_detector.py:116-120).  Device randomness goes
    through explicit ``torch.Generator``s."""
    seed = seed + rank
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
