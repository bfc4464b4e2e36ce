"""Per-Gaussian preprocessing: frustum cull, EWA 3D->2D covariance, conic,
radius, SH colour, inverse depth (counterpart of the JAX package's
``ops/projection.py``).

Numerical contract, as in the JAX package:
  * cull when camera-space z <= 0.2 (and rows outside ``valid_mask``);
  * J uses t.x/t.y clamped to +-1.3 tan(fov/2) z;
  * the 2D covariance is dilated by +0.3 on the diagonal;
  * antialiasing scales opacity by sqrt(max(2.5e-5, det(S)/det(S + 0.3 I)));
  * radius = ceil(3 sqrt(lambda_max)), lambda from mid + sqrt(max(0.1, mid^2 - det));
  * pixel coordinates ((v + 1) S - 1) / 2;
  * mean2d stays f32; conic, opacity, rgb and inverse depth are rounded
    once to bf16 (RTNE), kept in f32 tensors.
Geometry products run in full f32: the package switches TF32 off when it
is imported.

:func:`project_state` projects a whole store on the card in one launch:
K8 (``csrc/project_fwd.cu``), whose plain version
:func:`project_state_plain` is :func:`project_gaussians` over the store's
activations. ``ops/render.py`` takes K8 where the kernels run on the card
and autograd would record nothing (:func:`records_grad`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import kernels
from ..core import sh as shlib

FRUSTUM_NEAR_Z = 0.2
DILATION = 0.3
AA_DET_FLOOR = 2.5e-5
LAMBDA_FLOOR = 0.1
TILE = 16


def _round_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    nonfinite = (u & 0x7F800000) == 0x7F800000
    out = torch.where(nonfinite, u, rounded)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


class RoundBF16(torch.autograd.Function):
    """Round f32 to the nearest bf16 value (RTNE), staying f32, by bit
    arithmetic; NaN and Inf pass through unchanged. The backward is the
    identity in f32 (straight-through): a dtype round trip would also round
    the gradient to bf16."""

    @staticmethod
    def forward(ctx, x):
        return _round_bf16_bits(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return RoundBF16.apply(x)


@dataclasses.dataclass
class ProjectedGaussians:
    """Screen-space Gaussians ready for binning and compositing."""

    mean2d: torch.Tensor    # (N, 2) pixel coordinates
    conic: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c)
    opacity: torch.Tensor   # (N,) post-activation, AA-rescaled
    rgb: torch.Tensor       # (N, 3)
    depth: torch.Tensor     # (N,) camera-space z; inf when culled
    invdepth: torch.Tensor  # (N,) 1/z
    radius: torch.Tensor    # (N,) int32 screen radius in pixels; 0 = culled

    def replace(self, **kw) -> "ProjectedGaussians":
        return dataclasses.replace(self, **kw)


def compute_cov2d(mean3d, cov3d, viewmatrix, focal_x, focal_y,
                  tan_fovx, tan_fovy):
    """EWA splatting: (N, 2, 2) un-dilated J W S W^T J^T and the (N, 3)
    camera-space positions."""
    W = viewmatrix[:3, :3]
    t = mean3d @ W.T + viewmatrix[:3, 3]
    tz = t[:, 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txz = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    tyz = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(tz)
    j0 = torch.stack([focal_x * inv_z, zeros, -focal_x * txz * inv_z2], -1)
    j1 = torch.stack([zeros, focal_y * inv_z, -focal_y * tyz * inv_z2], -1)
    t0 = j0 @ W
    t1 = j1 @ W
    s00 = cov3d[:, 0, 0]
    s01 = cov3d[:, 0, 1]
    s02 = cov3d[:, 0, 2]
    s11 = cov3d[:, 1, 1]
    s12 = cov3d[:, 1, 2]
    s22 = cov3d[:, 2, 2]

    def quad(a, b):
        return (a[:, 0] * b[:, 0] * s00 + a[:, 1] * b[:, 1] * s11
                + a[:, 2] * b[:, 2] * s22
                + (a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0]) * s01
                + (a[:, 0] * b[:, 2] + a[:, 2] * b[:, 0]) * s02
                + (a[:, 1] * b[:, 2] + a[:, 2] * b[:, 1]) * s12)

    c00 = quad(t0, t0)
    c01 = quad(t0, t1)
    c11 = quad(t1, t1)
    cov2d = torch.stack([torch.stack([c00, c01], -1),
                         torch.stack([c01, c11], -1)], -2)
    return cov2d, t


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacity: torch.Tensor,
    sh_coeffs: torch.Tensor,
    sh_degree: int,
    viewmatrix: torch.Tensor,
    full_proj: torch.Tensor,
    cam_center: torch.Tensor,
    width: int,
    height: int,
    tan_fovx: float,
    tan_fovy: float,
    antialiasing: bool = False,
    valid_mask: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    map_width=None,
    map_height=None,
) -> ProjectedGaussians:
    """Full preprocess. Culled and padded rows get radius 0 and opacity 0.

    `map_width`/`map_height` (numbers or 0-dim tensors) replace `width`/
    `height` in the pixel mapping and the focal lengths, for a camera
    zero-padded onto a larger canvas; `tan_fovx`/`tan_fovy` may then be
    0-dim tensors too."""
    mw = width if map_width is None else map_width
    mh = height if map_height is None else map_height
    focal_x = mw / (2.0 * tan_fovx)
    focal_y = mh / (2.0 * tan_fovy)

    hom = means3d @ full_proj[:3, :3].T + full_proj[:3, 3]
    w = means3d @ full_proj[3, :3] + full_proj[3, 3]
    inv_w = 1.0 / (w + 1e-7)
    ndc = hom * inv_w[:, None]
    mean2d = torch.stack([((ndc[:, 0] + 1.0) * mw - 1.0) * 0.5,
                          ((ndc[:, 1] + 1.0) * mh - 1.0) * 0.5], -1)

    cov2d, t = compute_cov2d(means3d, cov3d, viewmatrix, focal_x, focal_y,
                             tan_fovx, tan_fovy)
    det_raw = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    cxx = cov2d[:, 0, 0] + DILATION
    cyy = cov2d[:, 1, 1] + DILATION
    cxy = cov2d[:, 0, 1]
    det = cxx * cyy - cxy * cxy
    det_inv = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], -1)

    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, LAMBDA_FLOOR))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    cull = (t[:, 2] <= FRUSTUM_NEAR_Z) | (det == 0.0)
    if valid_mask is not None:
        cull = cull | ~valid_mask
    radius = torch.where(cull, torch.zeros_like(radius), radius).to(torch.int32)

    op = opacity
    if antialiasing:
        op = op * torch.sqrt(torch.clamp_min(det_raw * det_inv, AA_DET_FLOOR))
    op = torch.where(cull, torch.zeros_like(op), op)

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        dirs = means3d - cam_center[None, :]
        dirs = dirs / torch.clamp_min(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-12)
        rgb = shlib.sh_to_color(sh_degree, sh_coeffs, dirs)

    inf = torch.full_like(t[:, 2], float("inf"))
    depth = torch.where(cull, inf, t[:, 2])
    invdepth = torch.where(cull, torch.zeros_like(depth),
                           1.0 / torch.clamp_min(t[:, 2], 1e-6))
    return ProjectedGaussians(
        mean2d=mean2d, conic=round_bf16(conic), opacity=round_bf16(op),
        rgb=round_bf16(rgb), depth=depth, invdepth=round_bf16(invdepth),
        radius=radius)


# --- K8: the projection of a store without autograd --------------------------

def records_grad(state, camera, override_color=None) -> bool:
    """Whether autograd would record a projection of `state` (a
    ``GaussianState``) from `camera`."""
    if not torch.is_grad_enabled():
        return False
    p = state.params
    return any(t is not None and t.requires_grad for t in (
        p.xyz, p.scaling, p.rotation, p.opacity, p.features_dc,
        p.features_rest, override_color, camera.world_view, camera.full_proj,
        camera.cam_center))


def project_state_plain(state, camera, *, scaling_modifier: float = 1.0,
                        antialiasing: bool = False,
                        override_color: Optional[torch.Tensor] = None
                        ) -> ProjectedGaussians:
    """Plain PyTorch version of K8 (see ``csrc/project_fwd.cu``):
    :func:`project_gaussians` over the store's activations, every row of
    the store, inactive rows culled."""
    return project_gaussians(
        state.params.xyz, state.get_covariance(scaling_modifier),
        state.get_opacity(), state.get_features(), state.max_sh_degree,
        camera.world_view, camera.full_proj, camera.cam_center, camera.width,
        camera.height, camera.tan_fovx, camera.tan_fovy,
        antialiasing=antialiasing, valid_mask=state.active,
        colors_precomp=override_color)


def project_state(state, camera, *, scaling_modifier: float = 1.0,
                  antialiasing: bool = False,
                  override_color: Optional[torch.Tensor] = None
                  ) -> ProjectedGaussians:
    """K8: :func:`project_state_plain` in one launch, for a store on the
    card. K8 has no backward and its outputs carry no graph, so callers
    take it only where autograd records nothing (:func:`records_grad`), as
    ``ops/render.py`` does. The SH colour uses the store's active degree,
    at most its maximum (4 at most); `override_color` (C, 3) replaces it."""
    p = state.params
    n = state.capacity
    ins = dict(xyz=p.xyz, scaling=p.scaling, rotation=p.rotation,
               opacity=p.opacity, features_dc=p.features_dc,
               features_rest=p.features_rest, world_view=camera.world_view,
               full_proj=camera.full_proj, cam_center=camera.cam_center)
    if override_color is not None:
        ins["override_color"] = override_color
    kernels.check_cuda("project_fwd", active=state.active, **ins)
    if any(t.dtype != torch.float32 for t in ins.values()) \
            or state.active.dtype != torch.bool:
        raise TypeError("project_fwd: f32 inputs and a bool active mask")
    rest_w = p.features_rest.shape[1] if p.features_rest.dim() == 2 else -1
    degree = (0 if override_color is not None
              else min(state.active_sh_degree, state.max_sh_degree))
    shapes = {"xyz": (n, 3), "scaling": (n, 3), "rotation": (n, 4),
              "opacity": (n, 1), "features_dc": (n, 3),
              "override_color": (n, 3), "world_view": (4, 4),
              "full_proj": (4, 4), "cam_center": (3,)}
    if any(tuple(t.shape) != shapes[k] for k, t in ins.items()
           if k != "features_rest") or state.active.shape != (n,) \
            or p.features_rest.shape[0] != n or n >= 2 ** 31 \
            or not 0 <= state.max_sh_degree <= shlib.MAX_SH_DEGREE \
            or rest_w < 3 * (shlib.num_sh_bases(state.max_sh_degree) - 1):
        raise ValueError("project_fwd: shapes do not match the store")
    dev = p.xyz.device
    f32 = torch.float32
    out = ProjectedGaussians(
        mean2d=torch.empty(n, 2, dtype=f32, device=dev),
        conic=torch.empty(n, 3, dtype=f32, device=dev),
        opacity=torch.empty(n, dtype=f32, device=dev),
        rgb=torch.empty(n, 3, dtype=f32, device=dev),
        depth=torch.empty(n, dtype=f32, device=dev),
        invdepth=torch.empty(n, dtype=f32, device=dev),
        radius=torch.empty(n, dtype=torch.int32, device=dev))
    # The scalars as project_gaussians makes them: Python doubles, rounded
    # to f32 where they meet a tensor.
    width, height = camera.width, camera.height
    tan_x, tan_y = camera.tan_fovx, camera.tan_fovy
    ptr, i, f = kernels.ptr, kernels.i32, kernels.f32
    kernels.launch(
        "project_fwd", [ptr] * 11 + [i] * 3 + [f] * 7 + [i] + [ptr] * 7,
        p.xyz, p.scaling, p.rotation, p.opacity, state.active,
        p.features_dc, p.features_rest, override_color, camera.world_view,
        camera.full_proj, camera.cam_center, n, rest_w, degree,
        float(scaling_modifier), width / (2.0 * tan_x),
        height / (2.0 * tan_y), 1.3 * tan_x, 1.3 * tan_y, float(width),
        float(height),
        int(antialiasing), out.mean2d, out.conic, out.opacity, out.rgb,
        out.depth, out.invdepth, out.radius)
    return out


def tile_rect_tight(proj: ProjectedGaussians, width: int, height: int):
    """Exact axis-aligned tile rect of the alpha >= 1/255 level set, clipped
    to the 3-sigma square; (xmin, ymin, xmax, ymax) half-open int32."""
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    a = proj.conic[:, 0]
    b = proj.conic[:, 1]
    c = proj.conic[:, 2]
    detc = a * c - b * b
    inv = 1.0 / torch.clamp_min(detc, 1e-30)
    sxx = c * inv
    syy = a * inv
    alpha_min = 1.0 / 255.0
    tau = torch.clamp_min(
        2.0 * torch.log(torch.clamp_min(proj.opacity, 1e-12) / alpha_min), 0.0)
    r3 = proj.radius.to(torch.float32)
    rx = torch.minimum(torch.sqrt(torch.clamp_min(tau * sxx, 0.0)) + 1.0, r3)
    ry = torch.minimum(torch.sqrt(torch.clamp_min(tau * syy, 0.0)) + 1.0, r3)
    empty = (proj.radius <= 0) | (proj.opacity < alpha_min)
    mx = proj.mean2d[:, 0]
    my = proj.mean2d[:, 1]

    def cell(v, hi):
        return torch.clamp((v / TILE).to(torch.int32), 0, hi)

    xmin = cell(mx - rx, grid_x)
    ymin = cell(my - ry, grid_y)
    xmax = cell(mx + rx + TILE - 1, grid_x)
    ymax = cell(my + ry + TILE - 1, grid_y)
    xmax = torch.where(empty, xmin, torch.maximum(xmax, xmin))
    ymax = torch.where(empty, ymin, torch.maximum(ymax, ymin))
    return xmin, ymin, xmax, ymax


def tile_rect(mean2d: torch.Tensor, radius: torch.Tensor, width: int,
              height: int):
    """Tile-grid bounding rect, CUDA ``getRect`` semantics; radius 0 gives
    an empty rect. (xmin, ymin, xmax, ymax) half-open int32."""
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    r = radius.to(torch.float32)

    def cell(v, hi):
        return torch.clamp((v / TILE).to(torch.int32), 0, hi)

    xmin = cell(mean2d[:, 0] - r, grid_x)
    ymin = cell(mean2d[:, 1] - r, grid_y)
    xmax = cell(mean2d[:, 0] + r + TILE - 1, grid_x)
    ymax = cell(mean2d[:, 1] + r + TILE - 1, grid_y)
    empty = radius <= 0
    xmax = torch.where(empty, xmin, xmax)
    ymax = torch.where(empty, ymin, ymax)
    return xmin, ymin, xmax, ymax
