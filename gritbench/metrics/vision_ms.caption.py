"""Device ms a caption batch of the kernels launched under ``compute_vis``
(the Swin backbone, the detector and the grid network)."""

from gritbench.readers import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, ("gritbench.compute_vis",))
