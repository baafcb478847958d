"""Device ms a caption batch of the kernels launched inside the program's
``grit.lm_head`` spans (the language model's final norm, vocabulary head
and log-softmax, at the prefill and at each decode step)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.lm_head")
