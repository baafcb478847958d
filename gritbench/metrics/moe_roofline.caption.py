"""The routed experts' grouped GEMMs (``ops/moe.py``: two calls of the
library's ``torch._grouped_mm`` a MoE call, gate+up and down) against their
roofline: each launch's least time, the larger of its operations over 989
TFLOP/s and its bytes over 3.35 TB/s (the experts that got rows read once,
rows in and out once; ``counts/kimi_lm.py::grouped_gemm_work``), summed over
the profiled stretch and divided by the grouped GEMM kernels' device time.
Silent unless the trace holds two such launches for each MoE call the
program recorded, and the program counted one call of each product."""

from gritbench import peaks
from gritbench.counts.kimi_lm import grouped_gemm_work
from gritbench.readers import stretch

#: The library's grouped GEMM kernel (CUTLASS's grouped problem shape): no
#: other kernel of the cell has it in its name
KERNEL = r"GroupProblemShape"


def read(rec):
    got = stretch(rec)
    moe = (rec.get("stretch") or {}).get("moe")
    if got is None or not moe or not moe["loads"]:
        return None
    tr, _ = got
    n = len(moe["loads"])
    if tr.count(KERNEL) != 2 * n or any(moe["launches"].get(f"moe_{part}") != n
                                        for part in ("gate_up", "down")):
        return None
    dtype = rec["dtype"]
    least = 0.0
    for counts in moe["loads"]:
        flops, nbytes = grouped_gemm_work(counts, rec["moe_dims"], peaks.BYTES[dtype])
        least += sum(max(flops[p] / peaks.FLOPS[dtype], nbytes[p] / peaks.HBM_BYTES_PER_S)
                     for p in flops)
    busy = tr.device_s(pattern=KERNEL)
    return 100.0 * least / busy if busy > 0 else None
