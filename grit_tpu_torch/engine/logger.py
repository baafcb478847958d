"""Scalar logging: an append-only jsonl file.

The reference logs scalars through torch's SummaryWriter
(train_caption.py:65, caption_engine.py:133-141,352-363).  This writer keeps
the same call sites (``writer.scalar(tag, value, step)``) and writes a
greppable ``scalars.jsonl``, as grit_tpu.engine.logger does; it mirrors to no
TensorBoard event file.
"""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "scalars.jsonl")

    def scalar(self, tag: str, value: float, step: int) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(
                {"t": time.time(), "tag": tag, "value": float(value), "step": int(step)}
            ) + "\n")

    # SummaryWriter-compat alias
    add_scalar = scalar

    def close(self) -> None:
        pass
