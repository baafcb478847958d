"""Device ms a caption batch of the kernels launched inside the program's
``grit.cache_reorder`` spans (each decode step's ``index_select`` of the
KV caches by parent beam, ``decoding/beam_search.py``)."""

from gritbench.spans import device_ms


def read(rec):
    return device_ms(rec, "grit.cache_reorder")
