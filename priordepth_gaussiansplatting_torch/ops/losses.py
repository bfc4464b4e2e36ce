"""Training losses and image metrics (counterpart of the JAX package's
``ops/losses.py``)."""

from __future__ import annotations

import torch

from .ssim import ssim  # noqa: F401  (re-export)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM), the reference's composite."""
    return ((1.0 - lambda_dssim) * l1_loss(pred, target)
            + lambda_dssim * (1.0 - ssim(pred, target)))


def depth_l1_loss(rendered_invdepth: torch.Tensor,
                  mono_invdepth: torch.Tensor,
                  depth_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean |render_inv - mono_inv|, the mean over ALL pixels (the
    reference's ``(err * mask).mean()``)."""
    return torch.mean(torch.abs(rendered_invdepth - mono_invdepth)
                      * depth_mask)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """20 log10(1 / sqrt(mse))."""
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))
