"""Kernels of the port: each a hand-written CUDA kernel for Hopper under
``csrc/`` with its plain PyTorch version beside it in the same module; and
the plain PyTorch ops around them (SpecAugment, weight-only int8)."""
