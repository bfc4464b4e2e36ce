"""Evaluation render (counterpart of the JAX package's ``train/step.py::
eval_image``; the training step comes with the backward kernels)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.cameras import Camera
from ..models.gaussians import GaussianState
from ..ops import losses
from ..ops.render import render


@torch.no_grad()
def eval_image(camera: Camera, state: GaussianState, bg: torch.Tensor,
               antialiasing: bool = False, use_trained_exp: bool = False,
               backend: str = "auto", pair_capacity: Optional[int] = None):
    """No-grad render plus PSNR/L1 against the camera's image, if any.
    ``overflow`` is returned so callers can warn: an overflowed render is
    missing pairs."""
    out = render(camera, state, bg, antialiasing=antialiasing,
                 use_trained_exp=use_trained_exp, backend=backend,
                 pair_capacity=pair_capacity)
    img = out["render"]
    res = {"render": img}
    if out.get("overflow") is not None:
        res["overflow"] = out["overflow"]
    if camera.image is not None:
        res["psnr"] = losses.psnr(img, camera.image)
        res["l1"] = losses.l1_loss(img, camera.image)
    return res
