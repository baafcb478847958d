"""Device ms a caption batch of the kernels launched inside the program's
``grit.lm_prefill`` span (the projector and the language model's prefill of
the prefix and BOS, ``models/lm_captioner.py::precompute_vis_kv``)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.lm_prefill")
