"""Kernel launches a training step: the kernel records of the profiled
stretch over its steps (the step's host dispatch shows here)."""

from gritbench.readers import launches_per_unit as read  # noqa: F401
