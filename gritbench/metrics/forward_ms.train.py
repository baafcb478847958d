"""Device ms a training step of the kernels launched inside the program's
``grit.forward`` span (the model's forward, ``engine/xe.py`` and
``detection/solver.py``)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.forward")
