"""PyTorch + CUDA port of the arbitrary-precision (bipolar-INT) serving
stack for NVIDIA Hopper.

Mirrors the layout of the reference JAX package ``repro`` module for
module; it imports torch and numpy only, never ``jax`` and nothing of
``repro``.  Hand-written CUDA kernels live in ``csrc/`` and are built on
first use (:mod:`repro_torch.kernels._build`); every kernel wrapper runs
its plain torch version for CPU tensors and launches the kernel for CUDA
tensors.
"""
