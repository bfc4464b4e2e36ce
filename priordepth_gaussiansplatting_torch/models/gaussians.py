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
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import transforms


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


@dataclasses.dataclass
class GaussianState:
    """Parameters plus the active mask of the fixed-capacity store."""

    params: GaussianParams
    active: torch.Tensor              # (C,) bool
    active_sh_degree: int
    max_sh_degree: int = 3

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
        zeroed."""
        feats = torch.cat([self.params.features_dc,
                           self.params.features_rest], dim=1)
        k = feats.shape[1] // 3
        band = torch.cat([torch.full(((2 * d + 1) * 3,), d)
                          for d in range(int(round(k ** 0.5)))])
        mask = (band <= self.active_sh_degree).to(feats.dtype)
        return feats * mask.to(feats.device)[None, :]

    def get_exposure(self, exposure_id: int) -> torch.Tensor:
        return self.params.exposure[exposure_id]

    def replace(self, **kw) -> "GaussianState":
        return dataclasses.replace(self, **kw)
