"""Device ms a caption batch of the kernels launched under the visual K/V
projection and the beam search (which calls the decode step)."""

from gritbench.readers import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, ("gritbench.precompute_vis_kv", "gritbench.beam_search"))
