"""CPU tests of the benchmark harness, its yardstick and its reference."""
