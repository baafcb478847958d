"""PyTorch/CUDA port of grit_tpu for NVIDIA Hopper (H100).

Mirrors ``grit_tpu``'s module paths.  Imports ``torch`` and never JAX; the
jax-free helpers of ``grit_tpu`` (config, data fields and transforms) are
shared.  Kernels are hand-written CUDA C++ under ``csrc/``, built at first
use by ``grit_tpu_torch.ops._cuda``.
"""
