"""PyTorch/CUDA port of the GETA reproduction (`repro`), for NVIDIA Hopper.

Mirrors the subpackages of `repro` (configs, core, kernels, models,
launch). It imports torch, numpy and the standard library only; its CUDA
kernels (`kernels/csrc`) build with nvcc at first use.
"""
