"""PyTorch/CUDA port of zeronotesamba_tpu for NVIDIA Hopper (H100).

The JAX package ``zeronotesamba_tpu`` is the reference; this package keeps
its module names and imports no JAX. Entry points run on the card unless the
caller passes ``device="cpu"``; the log-VQT's two kernels are hand-written
CUDA (csrc/), built with nvcc at first CUDA use.
"""
