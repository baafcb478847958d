"""Device-idle ms a caption batch while the host is inside the program's
``grit.beam_search`` span: the decode loop's Python and the sync that
reads its early-exit flag each step."""

from gritbench.spans import idle_ms


def read(rec):
    return idle_ms(rec, "grit.beam_search")
