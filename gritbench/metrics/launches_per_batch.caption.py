"""Kernel launches a caption batch: the kernel records of the profiled
stretch over its batches (the entry's and the loops' host work shows here)."""

from gritbench.readers import launches_per_unit as read  # noqa: F401
