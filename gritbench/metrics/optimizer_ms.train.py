"""Device ms a training step of the kernels launched inside the program's
``grit.optimizer`` span (the detector's zero-filled missing gradients and
clip, and the Adam step)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.optimizer")
