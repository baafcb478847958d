"""Device ms a caption batch of the kernels launched inside the program's
``grit.backbone`` span (the Swin backbone, ``models/detector.py``)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.backbone")
