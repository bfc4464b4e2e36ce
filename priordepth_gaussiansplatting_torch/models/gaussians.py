"""The Gaussian scene model as a fixed-capacity store with an active mask
(counterpart of the JAX package's ``models/gaussians.py``).

Parameter groups and storage spaces are the JAX package's:
  xyz           (C, 3)      world positions
  features_dc   (C, 3)      SH DC coefficients
  features_rest (C, 3(K-1)) higher SH bands, flat channel-minor layout
  scaling       (C, 3)      log-space
  rotation      (C, 4)      unnormalised quaternion (w, x, y, z)
  opacity       (C, 1)      inverse-sigmoid space
  exposure      (M, 3, 4)   per-training-image affine colour transform
SH bands above ``active_sh_degree`` are masked to zero in
:meth:`GaussianState.get_features`, so the basis is always max-degree.
Densification keeps its statistics beside the parameters: ``max_radii2d``,
``xyz_gradient_accum`` and ``denom`` (C,) f32, zeros when not given.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core import sh as shlib
from ..core import transforms
from ..device import resolve_device
from ..ops.knn import mean_knn_sq_dist


@dataclasses.dataclass
class GaussianParams:
    """Parameters in their storage (pre-activation) spaces."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    exposure: torch.Tensor

    def replace(self, **kw) -> "GaussianParams":
        return dataclasses.replace(self, **kw)


PARAM_NAMES = tuple(f.name for f in dataclasses.fields(GaussianParams))


@functools.lru_cache(maxsize=None)
def _sh_band(k: int, device: torch.device) -> torch.Tensor:
    """(3K,) int32 SH degree of each flat feature column, on `device`."""
    band = np.concatenate([np.full((2 * d + 1) * 3, d)
                           for d in range(int(round(k ** 0.5)))])
    return torch.as_tensor(band, dtype=torch.int32, device=device)


@dataclasses.dataclass
class GaussianState:
    """Parameters, the active mask of the fixed-capacity store and the
    densification statistics."""

    params: GaussianParams
    active: torch.Tensor              # (C,) bool
    active_sh_degree: int
    max_sh_degree: int = 3
    max_radii2d: Optional[torch.Tensor] = None         # (C,) f32
    xyz_gradient_accum: Optional[torch.Tensor] = None  # (C,) f32
    denom: Optional[torch.Tensor] = None               # (C,) f32
    spatial_lr_scale: float = 1.0

    def __post_init__(self):
        for name in ("max_radii2d", "xyz_gradient_accum", "denom"):
            if getattr(self, name) is None:
                setattr(self, name, torch.zeros(
                    self.active.shape[0], dtype=torch.float32,
                    device=self.active.device))

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active.to(torch.int32))

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.params.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity[:, 0]) * self.active

    def get_rotation(self) -> torch.Tensor:
        return transforms.normalize_quat(self.params.rotation)

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        return transforms.scaling_rotation_to_cov3d(
            self.get_scaling() * scaling_modifier, self.params.rotation)

    def get_features(self) -> torch.Tensor:
        """(C, 3K) flat SH coefficients with bands above the active degree
        zeroed. The band table is built once per device (no host copy per
        call)."""
        feats = torch.cat([self.params.features_dc,
                           self.params.features_rest], dim=1)
        band = _sh_band(feats.shape[1] // 3, feats.device)
        mask = (band <= self.active_sh_degree).to(feats.dtype)
        return feats * mask[None, :]

    def get_exposure(self, exposure_id: int) -> torch.Tensor:
        return self.params.exposure[exposure_id]

    def oneup_sh_degree(self) -> "GaussianState":
        return self.replace(active_sh_degree=min(self.active_sh_degree + 1,
                                                 self.max_sh_degree))

    def replace(self, **kw) -> "GaussianState":
        return dataclasses.replace(self, **kw)


def create_from_points(points: np.ndarray, colors: np.ndarray,
                       num_images: int, capacity: int | None = None,
                       max_sh_degree: int = 3, spatial_lr_scale: float = 1.0,
                       device=None) -> GaussianState:
    """Initialise from an SfM point cloud (reference ``create_from_pcd``):
    RGB -> SH DC, log-sqrt-KNN scales, identity quaternions, opacity 0.1,
    identity exposures; on `device` (the card unless the caller names the
    CPU). Padding rows get unit quaternions and scales of 1e-6."""
    device = resolve_device(device)
    n = points.shape[0]
    if capacity is None:
        capacity = int(max(2 ** int(np.ceil(np.log2(max(n * 4, 1024)))),
                           1024))
    if capacity < n:
        raise ValueError(f"capacity {capacity} < initial points {n}")
    k = shlib.num_sh_bases(max_sh_degree)
    f32 = torch.float32
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    dist2 = torch.clamp_min(mean_knn_sq_dist(pts), 1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        extra = torch.full((capacity - n,) + tuple(x.shape[1:]), fill,
                           dtype=f32, device=device)
        return torch.cat([x, extra])

    rgb = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    rotation = torch.zeros(capacity, 4, dtype=f32, device=device)
    rotation[:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(pts),
        features_dc=pad(shlib.rgb_to_sh(rgb)),
        features_rest=torch.zeros(capacity, (k - 1) * 3, dtype=f32,
                                  device=device),
        scaling=pad(scales, float(np.log(1e-6))),
        rotation=rotation,
        opacity=torch.full((capacity, 1), float(transforms.inverse_sigmoid(
            torch.tensor(0.1))), dtype=f32, device=device),
        exposure=torch.eye(3, 4, dtype=f32, device=device)[None].repeat(
            max(num_images, 1), 1, 1),
    )
    return GaussianState(
        params=params, active=torch.arange(capacity, device=device) < n,
        active_sh_degree=0, max_sh_degree=max_sh_degree,
        spatial_lr_scale=float(spatial_lr_scale))


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Regrow the store to `new_capacity` rows, keeping every live row; the
    new rows are padding (scales 1e-6, opacity -6, unit quaternions)."""
    c = state.capacity
    if new_capacity <= c:
        return state
    extra = new_capacity - c
    dev = state.active.device

    def padp(x, fill=0.0):
        return torch.cat([x, torch.full((extra,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=dev)])

    p = state.params
    unit = torch.zeros(extra, 4, dtype=p.rotation.dtype, device=dev)
    unit[:, 0] = 1.0
    params = GaussianParams(
        xyz=padp(p.xyz), features_dc=padp(p.features_dc),
        features_rest=padp(p.features_rest),
        scaling=padp(p.scaling, float(np.log(1e-6))),
        rotation=torch.cat([p.rotation, unit]),
        opacity=padp(p.opacity, -6.0), exposure=p.exposure)
    return state.replace(
        params=params, active=padp(state.active, False),
        max_radii2d=padp(state.max_radii2d),
        xyz_gradient_accum=padp(state.xyz_gradient_accum),
        denom=padp(state.denom))
