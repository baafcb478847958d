"""Model operations of the training steps (three forwards a step, nothing
recomputed; ``gritbench/counts/``) over the traced run's window, as a share
of the peak of the configuration's type."""

from gritbench.readers import mfu_percent as read  # noqa: F401
