"""Oracle rasterizer: slow, plainly right, dense per pixel over all
Gaussians (counterpart of the JAX package's ``ops/reference.py``). The CPU
render backend and a second check of the tile pipeline.

Semantics: global front-to-back depth order; a Gaussian touches a pixel iff
the pixel's 16x16 tile lies in its ``tile_rect``; alpha = min(0.99,
op e^power), skipped if power > 0 or alpha < 1/255; stop before the
Gaussian that would take T below 1e-4; output C + T_final bg.
"""

from __future__ import annotations

import torch

from .projection import TILE, ProjectedGaussians, tile_rect

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def _composite_pixels(px, py, mean2d, conic, opacity, rgb, invdepth,
                      txmin, tymin, txmax, tymax):
    """(P,) pixel coordinates against all depth-sorted Gaussians ->
    (P, 3) colour, (P,) inverse depth, (P,) final T."""
    tx = torch.div(px, TILE, rounding_mode="floor").to(torch.int32)
    ty = torch.div(py, TILE, rounding_mode="floor").to(torch.int32)
    in_rect = ((tx[:, None] >= txmin[None, :]) & (tx[:, None] < txmax[None, :])
               & (ty[:, None] >= tymin[None, :]) & (ty[:, None] < tymax[None, :]))
    dx = px[:, None] - mean2d[None, :, 0]
    dy = py[:, None] - mean2d[None, :, 1]
    power = (-0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
             - conic[None, :, 1] * dx * dy)
    alpha = torch.clamp_max(opacity[None, :] * torch.exp(power), ALPHA_MAX)
    keep = in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(keep, alpha, torch.zeros_like(alpha))
    cum = torch.cumprod(1.0 - a, dim=1)
    live = cum >= T_EPS
    t_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    w = torch.where(live, a * t_excl, torch.zeros_like(a))
    color = (w[:, :, None] * rgb[None, :, :]).sum(dim=1)
    inv_d = (w * invdepth[None, :]).sum(dim=1)
    final_t = torch.where(live, 1.0 - a, torch.ones_like(a)).prod(dim=1)
    return color, inv_d, final_t


def rasterize_reference(proj: ProjectedGaussians, bg: torch.Tensor,
                        width: int, height: int, pixel_chunk: int = 1024):
    """(3, H, W) render (background included), (1, H, W) inverse depth and
    (H, W) final T, pixel chunk by pixel chunk."""
    order = torch.sort(proj.depth, stable=True).indices
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    opacity = proj.opacity[order]
    rgb = proj.rgb[order]
    invdepth = proj.invdepth[order]
    radius = proj.radius[order]
    rect = tile_rect(mean2d, radius, width, height)

    npix = height * width
    idx = torch.arange(npix, device=mean2d.device)
    ys = torch.div(idx, width, rounding_mode="floor").to(torch.float32)
    xs = (idx % width).to(torch.float32)
    colors, invds, finals = [], [], []
    for s in range(0, npix, pixel_chunk):
        c, d, t = _composite_pixels(xs[s:s + pixel_chunk],
                                    ys[s:s + pixel_chunk], mean2d, conic,
                                    opacity, rgb, invdepth, *rect)
        colors.append(c)
        invds.append(d)
        finals.append(t)
    color = torch.cat(colors)
    final_t = torch.cat(finals)
    image = (color.T.reshape(3, height, width)
             + final_t.reshape(1, height, width) * bg[:, None, None])
    return {
        "render": image,
        "invdepth": torch.cat(invds).reshape(1, height, width),
        "final_T": final_t.reshape(height, width),
    }
