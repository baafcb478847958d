"""Device ms a training step of the kernels launched inside the program's
``grit.backward`` span, from any thread (autograd's worker launches the
backward's kernels)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.backward")
