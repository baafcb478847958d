"""Ops: window helpers, position tables, and the Hopper kernels K1-K3."""
