"""Carry values from the JAX package into the port as numpy arrays, so both
compute the same thing on the same inputs, and the port's state back out to
numpy for comparison. Takes numpy (or anything ``np.asarray`` accepts) and
imports nothing of the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from .core.cameras import Camera
from .device import resolve_device
from .models.gaussians import PARAM_NAMES as PARAM_FIELDS
from .models.gaussians import GaussianParams, GaussianState
from .ops.projection import ProjectedGaussians
from .train.optim import AdamState

STAT_FIELDS = ("max_radii2d", "xyz_gradient_accum", "denom")


def _f32(x, device):
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def gaussian_state_from_numpy(params: dict, active, active_sh_degree: int,
                              max_sh_degree: int, device=None,
                              spatial_lr_scale: float = 1.0,
                              **stats) -> GaussianState:
    """A GaussianState from the JAX ``GaussianParams`` fields (a dict of
    arrays keyed by field name), the active mask and, optionally, the
    densification statistics (``max_radii2d``, ``xyz_gradient_accum``,
    ``denom``; zeros when left out)."""
    device = resolve_device(device)
    return GaussianState(
        params=GaussianParams(**{k: _f32(params[k], device)
                                 for k in PARAM_FIELDS}),
        active=torch.as_tensor(np.asarray(active, dtype=bool), device=device),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree),
        spatial_lr_scale=float(spatial_lr_scale),
        **{k: _f32(v, device) for k, v in stats.items()})


def gaussian_state_to_numpy(state: GaussianState) -> dict:
    """The state's tensors as numpy: {field: array} for the parameters,
    ``active`` and the statistics."""
    out = {k: getattr(state.params, k).detach().cpu().numpy()
           for k in PARAM_FIELDS}
    out["active"] = state.active.cpu().numpy()
    out.update({k: getattr(state, k).cpu().numpy() for k in STAT_FIELDS})
    return out


def adam_state_from_numpy(mu: dict, nu: dict, count: int,
                          device=None) -> AdamState:
    """An AdamState from the JAX one's moments (dicts keyed by parameter
    field) and step count."""
    device = resolve_device(device)
    return AdamState(
        mu=GaussianParams(**{k: _f32(mu[k], device) for k in PARAM_FIELDS}),
        nu=GaussianParams(**{k: _f32(nu[k], device) for k in PARAM_FIELDS}),
        count=torch.tensor(int(count), dtype=torch.int32, device=device))


def adam_state_to_numpy(opt: AdamState) -> dict:
    """{"mu": {field: array}, "nu": {...}, "count": int}."""
    def tree(p):
        return {k: getattr(p, k).cpu().numpy() for k in PARAM_FIELDS}
    return {"mu": tree(opt.mu), "nu": tree(opt.nu), "count": int(opt.count)}


def camera_from_numpy(world_view, full_proj, cam_center, width: int,
                      height: int, fovx: float, fovy: float, image=None,
                      exposure_id: int = -1, invdepth=None, depth_mask=None,
                      alpha_mask=None, device=None) -> Camera:
    """A Camera from the JAX camera's matrices and metadata."""
    device = resolve_device(device)

    def opt(x):
        return None if x is None else _f32(x, device)
    return Camera(
        world_view=_f32(world_view, device), full_proj=_f32(full_proj, device),
        cam_center=_f32(cam_center, device), image=opt(image),
        invdepth=opt(invdepth), depth_mask=opt(depth_mask),
        alpha_mask=opt(alpha_mask),
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
