"""PyTorch/CUDA port of grit_tpu for NVIDIA Hopper (H100).

Mirrors ``grit_tpu``'s module paths and imports nothing of it: ``torch`` and
never JAX, and its own copies of the config tree, the text fields and the
image transforms.  Kernels are hand-written CUDA C++ under ``csrc/``, built at
first use by ``grit_tpu_torch.ops._cuda``.  Entry points run on the GPU unless
the caller asks for the CPU.
"""
