"""The port's bf16 GEMM (``csrc/gemm_sm90.cu``) against its roofline: the
least time of each launch of a caption batch over their device time."""

from gritbench.readers import gemm_roofline_percent as read  # noqa: F401
