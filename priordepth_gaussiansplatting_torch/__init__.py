"""PyTorch/CUDA port of priordepth_gaussiansplatting_tpu.

The package mirrors the JAX package's module paths. It imports torch and
numpy, never jax and nothing of the JAX package. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``; the hand-written
kernels live in ``csrc/`` and are built at first use (``kernels/build.py``).
"""

import torch

from .device import launch_counts, reset_launch_counts, resolve_device  # noqa: F401

# The geometry's matrix products and SSIM's convolutions must run in true
# f32 on the card: cuDNN's TF32 (on by default) takes SSIM's sigma^2
# negative past C2. Set once, here, for the process.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
