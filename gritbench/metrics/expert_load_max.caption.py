"""Expert load of the language-model captioner's mixture-of-experts layers:
for each MoE call of the profiled stretch (each layer of the prefill and of
every decode step), the rows routed to its most-loaded expert over the mean
rows an expert, averaged over the calls (1: an even load).  Read from the
rows per expert that ``ops.moe`` records while the profiler runs."""


def read(rec):
    loads = ((rec.get("stretch") or {}).get("moe") or {}).get("loads")
    if not loads:
        return None
    return sum(max(c) * len(c) / sum(c) for c in loads) / len(loads)
