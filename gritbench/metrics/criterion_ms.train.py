"""Device ms a training step of the kernels launched inside the program's
``grit.criterion`` span (XE's NLL; the detector's criterion, matcher
included, and its weighted sum)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.criterion")
