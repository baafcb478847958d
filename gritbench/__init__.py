"""The benchmark of grit_tpu_torch on the H100 (``BENCHMARK.json``): one
command runs one cell once (``python3 -m gritbench.run``)."""
