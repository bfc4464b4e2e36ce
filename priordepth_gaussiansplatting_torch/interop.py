"""Carry values from the JAX package into the port as numpy arrays, so both
compute the same thing on the same inputs. Takes numpy (or anything
``np.asarray`` accepts) and imports nothing of the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from .core.cameras import Camera
from .device import resolve_device
from .models.gaussians import GaussianParams, GaussianState
from .ops.projection import ProjectedGaussians

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "exposure")


def _f32(x, device):
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def gaussian_state_from_numpy(params: dict, active, active_sh_degree: int,
                              max_sh_degree: int, device=None) -> GaussianState:
    """A GaussianState from the JAX ``GaussianParams`` fields (a dict of
    arrays keyed by field name) and the active mask."""
    device = resolve_device(device)
    return GaussianState(
        params=GaussianParams(**{k: _f32(params[k], device)
                                 for k in PARAM_FIELDS}),
        active=torch.as_tensor(np.asarray(active, dtype=bool), device=device),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree))


def camera_from_numpy(world_view, full_proj, cam_center, width: int,
                      height: int, fovx: float, fovy: float, image=None,
                      exposure_id: int = -1, device=None) -> Camera:
    """A Camera from the JAX camera's matrices and metadata."""
    device = resolve_device(device)
    return Camera(
        world_view=_f32(world_view, device), full_proj=_f32(full_proj, device),
        cam_center=_f32(cam_center, device),
        image=None if image is None else _f32(image, device),
        height=int(height), width=int(width), fovx=float(fovx),
        fovy=float(fovy), exposure_id=int(exposure_id))


def projected_from_numpy(mean2d, conic, opacity, rgb, depth, invdepth,
                         radius, device=None) -> ProjectedGaussians:
    """ProjectedGaussians from the JAX projection's outputs."""
    device = resolve_device(device)
    return ProjectedGaussians(
        mean2d=_f32(mean2d, device), conic=_f32(conic, device),
        opacity=_f32(opacity, device), rgb=_f32(rgb, device),
        depth=_f32(depth, device), invdepth=_f32(invdepth, device),
        radius=torch.tensor(np.asarray(radius, dtype=np.int32),
                               device=device))
