"""Device-idle ms a training step while the host is inside the program's
``grit.backward`` span."""

from gritbench.spans import idle_ms


def read(rec):
    return idle_ms(rec, "grit.backward")
