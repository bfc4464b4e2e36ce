"""Synthetic scenes and reference functions shared by tests and the chip
smoke run.

``random_gaussians`` draws with numpy from a seed and returns numpy arrays,
so a test can hand the very same values to the JAX package and the port.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import cameras as camlib
from ..core import sh as shlib
from ..ops import binning, projection


def look_at_camera(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0),
                   fovx=math.radians(60), width=256, height=256,
                   device=None, **kw) -> camlib.Camera:
    """Camera at `eye` looking at `target` (COLMAP-style: +z forward, +y
    down), on `device` (the card unless the caller names the CPU)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    t = -R.T @ eye
    focal = width / (2.0 * math.tan(fovx / 2.0))
    fovy = 2.0 * math.atan(height / (2.0 * focal))
    return camlib.make_camera(R, t, fovx, fovy, width, height, device=device,
                              **kw)


def random_gaussians(seed: int, n: int, sh_degree: int = 3,
                     extent: float = 1.0, scale_range=(0.02, 0.1),
                     opacity_range=(0.3, 0.95)) -> dict:
    """World-space Gaussians (post-activation values) as f32 numpy arrays:
    means (n, 3), scales (n, 3), quats (n, 4), opacities (n,), sh (n, 3K)
    in the flat channel-minor layout."""
    rng = np.random.default_rng(seed)
    k = shlib.num_sh_bases(sh_degree)
    f32 = np.float32
    means = rng.uniform(-extent, extent, (n, 3)).astype(f32)
    scales = rng.uniform(scale_range[0], scale_range[1], (n, 3)).astype(f32)
    quats = rng.standard_normal((n, 4), dtype=f32)
    opac = rng.uniform(opacity_range[0], opacity_range[1], n).astype(f32)
    sh = 0.3 * rng.standard_normal((n, 3 * k), dtype=f32)
    sh[:, :3] = shlib.rgb_to_sh(rng.uniform(0.05, 0.95, (n, 3)).astype(f32))
    return dict(means=means, scales=scales, quats=quats, opacities=opac,
                sh=sh.astype(f32))


def enumerate_slots(proj, width: int, height: int) -> np.ndarray:
    """(tile, Gaussian) for every tile of every Gaussian's rect, the
    Gaussians in stable depth order and the tiles row-major: K7's slots
    written out as loops, (total, 2) int64."""
    grid_x, _ = binning.grid_shape(width, height)
    xmin, ymin, xmax, ymax = (t.tolist() for t in projection.tile_rect(
        proj.mean2d, proj.radius, width, height))
    order = np.argsort(proj.depth.cpu().numpy(), kind="stable")
    slots = [(ty * grid_x + tx, int(j)) for j in order
             for ty in range(ymin[j], ymax[j])
             for tx in range(xmin[j], xmax[j])]
    return np.array(slots, dtype=np.int64).reshape(-1, 2)
