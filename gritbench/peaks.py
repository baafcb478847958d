"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W limit), the yardstick of the roofline shares and of ``mfu``."""

FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float32": 4}
HBM_BYTES_PER_S = 3.35e12
