"""Camera model and view/projection matrices (counterpart of the JAX
package's ``core/cameras.py``).

Column-vector convention: ``p_cam = W2C @ [p; 1]``. Matrices are built in
float64 numpy exactly as the JAX package builds them, then stored as f32
tensors on the camera's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

DEFAULT_ZNEAR = 0.01
DEFAULT_ZFAR = 100.0


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray = None, scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix from COLMAP-convention (R, t): R is the
    camera-to-world rotation, t the world-to-camera translation."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        c2w = np.linalg.inv(Rt)
        c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
        Rt = np.linalg.inv(c2w)
    return Rt.astype(np.float32)


def perspective_projection(fovx: float, fovy: float,
                           znear: float = DEFAULT_ZNEAR,
                           zfar: float = DEFAULT_ZFAR) -> np.ndarray:
    """OpenGL-style perspective matrix, z in [0, 1], column-vector form."""
    tan_x = math.tan(fovx / 2.0)
    tan_y = math.tan(fovy / 2.0)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """One view: f32 tensors on one device plus static metadata.

      world_view: (4, 4) world->camera; full_proj: (4, 4) proj @ world_view;
      cam_center: (3,); image: (3, H, W) in [0, 1] or None; invdepth,
      depth_mask, alpha_mask: (H, W) or None.

    For a multi-rank batch (``parallel/step.py``): a camera zero-padded
    onto a larger canvas carries its true pixel size ``pix_wh`` = [w, h]
    and ``tan_wh`` = [tan_fovx, tan_fovy] as (2,) tensors (width and height
    are then the canvas's, fovx and fovy 0), and ``exposure_idx``, a 0-dim
    int32 tensor, overrides ``exposure_id`` for the exposure lookup.
    """

    world_view: torch.Tensor
    full_proj: torch.Tensor
    cam_center: torch.Tensor
    image: Optional[torch.Tensor] = None
    invdepth: Optional[torch.Tensor] = None
    depth_mask: Optional[torch.Tensor] = None
    alpha_mask: Optional[torch.Tensor] = None
    pix_wh: Optional[torch.Tensor] = None
    tan_wh: Optional[torch.Tensor] = None
    exposure_idx: Optional[torch.Tensor] = None
    height: int = 0
    width: int = 0
    fovx: float = 0.0
    fovy: float = 0.0
    znear: float = DEFAULT_ZNEAR
    zfar: float = DEFAULT_ZFAR
    exposure_id: int = -1
    image_name: str = ""
    depth_reliable: bool = False
    uid: int = 0

    @property
    def tan_fovx(self) -> float:
        return math.tan(self.fovx / 2.0)

    @property
    def tan_fovy(self) -> float:
        return math.tan(self.fovy / 2.0)


def _tensor(x, device):
    return None if x is None else torch.as_tensor(
        np.asarray(x, dtype=np.float32), device=device)


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, image=None, invdepth=None,
                depth_mask=None, alpha_mask=None, exposure_id: int = -1,
                image_name: str = "", depth_reliable: bool = False,
                uid: int = 0, translate=None, scale: float = 1.0,
                znear: float = DEFAULT_ZNEAR, zfar: float = DEFAULT_ZFAR,
                device=None) -> Camera:
    """Build a Camera from COLMAP-style extrinsics on `device` (the card
    unless the caller names the CPU)."""
    device = resolve_device(device)
    w2c = world_to_view(R, t, translate=translate, scale=scale)
    proj = perspective_projection(fovx, fovy, znear, zfar)
    full = proj @ w2c
    c2w = np.linalg.inv(w2c)
    return Camera(
        world_view=_tensor(w2c, device),
        full_proj=_tensor(full, device),
        cam_center=_tensor(c2w[:3, 3], device),
        image=_tensor(image, device),
        invdepth=_tensor(invdepth, device),
        depth_mask=_tensor(depth_mask, device),
        alpha_mask=_tensor(alpha_mask, device),
        height=int(height), width=int(width), fovx=float(fovx),
        fovy=float(fovy), znear=float(znear), zfar=float(zfar),
        exposure_id=int(exposure_id), image_name=image_name,
        depth_reliable=bool(depth_reliable), uid=int(uid),
    )
