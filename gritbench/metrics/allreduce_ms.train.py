"""Device ms a training step of the NCCL kernels on rank 0 (DDP's gradient
all-reduce and the step's small sums over the ranks), from the trace of
the profiled stretch."""

from gritbench.collectives import allreduce_ms as read  # noqa: F401
