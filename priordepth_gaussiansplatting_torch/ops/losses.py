"""Image losses and metrics (counterpart of the JAX package's
``ops/losses.py``; SSIM comes with the training path)."""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """20 log10(1 / sqrt(mse))."""
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))
