"""Device ms a caption batch of the kernels launched inside the program's
``grit.mla`` spans (every latent attention, prefill and decode,
``models/lm_decoder.py::LatentAttention``)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.mla")
