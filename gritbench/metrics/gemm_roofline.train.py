"""The port's GEMM of the configuration's type (``gemm_f32`` in float32
cells, ``gemm_bf16`` in bfloat16 ones) against its roofline: the least time
of each launch of a step over their device time."""

from gritbench.readers import gemm_roofline_percent as read  # noqa: F401
