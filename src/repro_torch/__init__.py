"""PyTorch/CUDA port of the MX serving stack.

The JAX package ``repro`` is the reference; this package mirrors its
layout (core, kernels, models, serve, launch) and runs on an NVIDIA
Hopper card.  Every kernel on the serving path is hand-written CUDA C++
under ``csrc/``, built with nvcc at first use; on a CPU tensor each
wrapper computes its plain PyTorch version instead.
"""
