"""Ms a training step on rank 0 in which an NCCL kernel runs and no other
kernel does: the exchange that the backward and the optimizer do not
hide."""

from gritbench.collectives import allreduce_exposed_ms as read  # noqa: F401
