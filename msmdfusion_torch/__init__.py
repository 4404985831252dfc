"""PyTorch + CUDA port of msmdfusion_tpu for NVIDIA Hopper (H100).

The JAX package ``msmdfusion_tpu`` is the reference; this package keeps its
layout and data contracts, runs its Pallas kernels as hand-written CUDA
kernels (``csrc/``), and imports nothing of it.
"""
