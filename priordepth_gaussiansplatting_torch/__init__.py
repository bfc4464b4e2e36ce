"""PyTorch/CUDA port of priordepth_gaussiansplatting_tpu.

The package mirrors the JAX package's module paths. It imports torch and
numpy, never jax and nothing of the JAX package. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``; the hand-written
kernels live in ``csrc/`` and are built at first use (``kernels/build.py``).
"""

from .device import launch_counts, reset_launch_counts, resolve_device  # noqa: F401

__version__ = "0.1.0"
