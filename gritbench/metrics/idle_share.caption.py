"""1 - the union of device intervals over the span of the profiled stretch
of caption batches."""

from gritbench.readers import idle_share as read  # noqa: F401
