"""Device ms a caption batch of the kernels launched inside the program's
``grit.beam_sort`` spans (each decode step's stable sort of the beam x
vocabulary candidates and its top-k slice, ``decoding/beam_search.py``)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.beam_sort")
