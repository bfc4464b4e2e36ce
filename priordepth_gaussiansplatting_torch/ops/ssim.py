"""SSIM (counterpart of the JAX package's ``ops/ssim.py``).

11x11 Gaussian window with sigma 1.5, C1 = 0.01^2, C2 = 0.03^2, zero-padded
"same" convolution, as the reference. The blur is separable: one 1x11 and
one 11x1 convolution over the five blurred fields at once. It must run in
true f32: in TF32 the error on blur(x^2) takes sigma^2 = blur(x^2) - mu^2
negative past C2 (the JAX package's parity notes). The package switches
cuDNN's and cuBLAS's TF32 off when it is imported. The JAX package's banded
MXU matmuls and bf16 limb splits have no counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window(window_size: int, device: torch.device) -> torch.Tensor:
    """The 1-D window on `device`, built once (no host copy per call)."""
    return torch.as_tensor(gaussian_window(window_size), device=device)


def _blur(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Separable same-padded Gaussian blur of (B, H, W) planes."""
    k = w.shape[0]
    y = F.conv2d(x[:, None], w.view(1, 1, 1, k), padding=(0, k // 2))
    y = F.conv2d(y, w.view(1, 1, k, 1), padding=(k // 2, 0))
    return y[:, 0]


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map (C, H, W)."""
    window = _window(window_size, img1.device)
    c = img1.shape[0]
    fields = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])
    mu1, mu2, b11, b22, b12 = torch.split(_blur(fields, window), c)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = b11 - mu1_sq
    sigma2_sq = b22 - mu2_sq
    sigma12 = b12 - mu1_mu2
    return ((2.0 * mu1_mu2 + C1) * (2.0 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) image pair in [0, 1]."""
    return torch.mean(ssim_map(img1, img2, window_size))
