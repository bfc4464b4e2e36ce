"""Evaluation metrics: LPIPS(VGG16) in PyTorch (counterpart of the JAX
package's ``eval/metrics.py``; reference ``lpipsPyTorch/``).

The learned weights are not bundled and nothing fetches them:
``PDGS_LPIPS_WEIGHTS`` names either
  * a ``.npz`` with ``features.<i>.weight/bias`` (torchvision's VGG16
    numbering) and the linear heads ``lin<k>.model.1.weight`` (or
    ``lins.<k>.model.1.weight``), or
  * a ``.pth`` state dict with the same keys (``scripts/
    export_lpips_weights.py`` writes the ``.npz``).
Without weights :func:`have_lpips` is False and :func:`compute_lpips`
returns -1. The convolutions are PyTorch's own (cuDNN on the card, TF32 off
as the package sets at import): in the JAX package too they sit outside
any Pallas kernel.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16's features: output channels of each conv, "M" a 2x2 max pool.
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512, "M"]
# LPIPS taps the relu after each block's last conv (torchvision indices):
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3.
_TAP_AFTER = {3, 8, 15, 22, 29}

# The reference ScalingLayer's shift and scale.
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    """LPIPS over VGG16 features: the 13 convolutions (each followed by a
    relu), 2x2 max pools between the blocks, unit-normalised channel
    differences at the five taps, 1x1 linear heads and a spatial mean."""

    def __init__(self, convs, lins):
        super().__init__()
        self.weights = nn.ParameterList(
            nn.Parameter(torch.as_tensor(np.array(w, np.float32)),
                         requires_grad=False) for w, _ in convs)
        self.biases = nn.ParameterList(
            nn.Parameter(torch.as_tensor(np.array(b, np.float32)),
                         requires_grad=False) for _, b in convs)
        self.lins = nn.ParameterList(
            nn.Parameter(torch.as_tensor(
                np.array(lin, np.float32).reshape(1, -1, 1, 1)),
                requires_grad=False) for lin in lins)
        self.register_buffer("shift", torch.as_tensor(_SHIFT).view(
            1, 3, 1, 1))
        self.register_buffer("scale", torch.as_tensor(_SCALE).view(
            1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list:
        """x: (1, 3, H, W) normalised; the five tap activations."""
        taps = []
        ci = layer = 0
        for item in _VGG_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                layer += 1
                continue
            x = F.relu(F.conv2d(x, self.weights[ci], self.biases[ci],
                                padding=1))
            ci += 1
            if layer + 1 in _TAP_AFTER:
                taps.append(x)
            layer += 2
        return taps

    @torch.no_grad()
    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """LPIPS of two (3, H, W) images in [0, 1], a 0-dim tensor."""
        def norm_input(x):
            return ((2.0 * x - 1.0)[None] - self.shift) / self.scale

        total = torch.zeros((), device=img1.device)
        for f1, f2, lin in zip(self.features(norm_input(img1)),
                               self.features(norm_input(img2)), self.lins):
            n1 = f1 / torch.sqrt(torch.sum(f1 ** 2, 1, keepdim=True) + 1e-10)
            n2 = f2 / torch.sqrt(torch.sum(f2 ** 2, 1, keepdim=True) + 1e-10)
            total = total + torch.mean(torch.sum((n1 - n2) ** 2 * lin, 1))
        return total


def _weights_path() -> str:
    return os.environ.get("PDGS_LPIPS_WEIGHTS", "")


@functools.lru_cache(maxsize=1)
def _load_weights():
    """The LPIPS module of ``PDGS_LPIPS_WEIGHTS`` on the CPU, or None
    without usable weights. Cached: ``_load_weights.cache_clear()`` reads
    the variable again."""
    path = _weights_path()
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        with np.load(path) as f:
            raw = dict(f)
    else:
        sd = torch.load(path, map_location="cpu")
        raw = {k: v.numpy() for k, v in sd.items()}
    keys = sorted((k for k in raw if k.endswith(".weight")
                   and "features" in k), key=lambda s: int(s.split(".")[-2]))
    convs = [(raw[k], raw[k.replace("weight", "bias")]) for k in keys]
    lins = []
    for k in range(5):
        for cand in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if cand in raw:
                lins.append(raw[cand])
                break
    if len(lins) != 5:
        return None
    return LPIPS(convs, lins)


def have_lpips() -> bool:
    return _load_weights() is not None


def compute_lpips(img1: torch.Tensor, img2: torch.Tensor) -> float:
    """LPIPS(VGG) of two (3, H, W) images in [0, 1] on their device; -1
    without weights."""
    net = _load_weights()
    if net is None:
        return -1.0
    return float(net.to(img1.device)(img1, img2))
