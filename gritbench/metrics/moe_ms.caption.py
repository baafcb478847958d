"""Device ms a caption batch of the kernels launched inside the program's
``grit.moe`` spans (every mixture-of-experts layer: the router, the routed
experts' grouped GEMMs of ``ops/moe.py`` and the shared experts,
``models/lm_decoder.py::MoE``)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.moe")
