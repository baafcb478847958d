"""Device ms a caption batch of the kernels launched inside the program's
``grit.det_module`` span (the input projections and the deformable
decoder, ``models/detector.py``)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.det_module")
