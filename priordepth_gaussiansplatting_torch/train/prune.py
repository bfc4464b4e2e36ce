"""Depth-prior floating-object pruning, the PriorDepth thesis module
(counterpart of the JAX package's ``train/prune.py``; reference
``GaussianOpt.py`` and its caller in ``train.py:193-291``).

Per view:

  * project the Gaussian centres through the camera's world->camera
    matrix, keep those that land on a pixel, in front of the camera,
    visible this frame and active (``valid_pixel_filter``);
  * read the rendered and the prior inverse depth at that pixel and
    linearise both: depth = 1 / (invdepth + 1e-6);
  * optionally fit (k, b) of rendered depth -> camera z by least squares
    over a circular table of (rendered depth, camera z) rows; the reference
    overrides the fit with (k, b) = (1, 0), the default here too;
  * prune (``floatingObj_prune``):
      (prior depth - rendered depth > cam_extent) and (cam_z < 20)
        and (cam_z - geometric-mean radius < rendered depth)
      or (cam_z < 20 and largest scale > 50).

``prune_loop`` renders random views and prunes until ``len(cameras)``
views in total (not in a row) have deleted nothing, as the reference does.
``inject_noise_gaussians`` is the reference's iteration-30000 experiment:
six bright floaters at z = 15 in free slots. Everything is plain PyTorch on
the state's device; the renders that feed ``prune_view`` go through the
port's render path (on the card: projection, K1, the tile sort, K5a, K2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.cameras import Camera
from ..device import resolve_device
from ..models import densify as densify_ops
from ..models.gaussians import GaussianState
from . import optim

EPSILON = 1e-6
MAX_TABLE = 100_000
NEAR_Z = 20.0
MAX_RADII_WORLD = 50.0


@dataclasses.dataclass
class FeatureTable:
    """Circular (rendered depth, camera z) buffer for the least-squares
    fit."""

    data: torch.Tensor   # (size, 2) f32
    index: torch.Tensor  # () int32, the next write position
    count: torch.Tensor  # () int32, the valid rows

    @staticmethod
    def empty(size: int = MAX_TABLE, device=None) -> "FeatureTable":
        """An empty table on `device` (the card unless the caller names the
        CPU)."""
        device = resolve_device(device)
        return FeatureTable(
            data=torch.zeros((size, 2), dtype=torch.float32, device=device),
            index=torch.zeros((), dtype=torch.int32, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device))


def least_squares_fit(feature: torch.Tensor, target: torch.Tensor,
                      mask: torch.Tensor):
    """Closed-form (k, b) with k x + b ~ y over the masked rows (the 2x2
    normal equations); (1, 0) and ok False when they are singular."""
    w = mask.to(torch.float32)
    n = torch.sum(w)
    sx = torch.sum(w * feature)
    sy = torch.sum(w * target)
    sxx = torch.sum(w * feature * feature)
    sxy = torch.sum(w * feature * target)
    det = n * sxx - sx * sx
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, torch.ones_like(det))
    k = torch.where(ok, (n * sxy - sx * sy) / safe, torch.ones_like(det))
    b = torch.where(ok, (sxx * sy - sx * sxy) / safe, torch.zeros_like(det))
    return k, b, ok


def update_table(table: FeatureTable, pairs: torch.Tensor,
                 valid: torch.Tensor) -> FeatureTable:
    """Append the valid rows of `pairs` at the write position, wrapping
    around; past the table's size only the first `size` valid rows are
    written."""
    size = table.data.shape[0]
    # Valid rows first, each group in order (a stable sort of a uint8 key).
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices
    n_add = torch.clamp(torch.sum(valid.to(torch.int32)), max=size)
    rows = torch.arange(pairs.shape[0], device=pairs.device)
    write = rows < n_add
    idx = (table.index + rows) % size
    data = table.data.clone()
    data[idx[write]] = pairs[order][write]
    return FeatureTable(data=data,
                        index=((table.index + n_add) % size).to(torch.int32),
                        count=torch.clamp(table.count + n_add,
                                          max=size).to(torch.int32))


@dataclasses.dataclass
class ViewTerms:
    """What one view says about each Gaussian: where its centre lands, its
    camera-space position and the two depths there."""

    cam_xyz: torch.Tensor        # (C, 3)
    px: torch.Tensor             # (C,) pixel coordinates of the centre
    py: torch.Tensor
    valid: torch.Tensor          # (C,) bool
    rend_invdepth: torch.Tensor  # (C,) the rendered inverse depth there
    rend_depth: torch.Tensor     # (C,)
    mono_depth: torch.Tensor     # (C,)

    @property
    def cam_z(self) -> torch.Tensor:
        return self.cam_xyz[:, 2]


def view_terms(state: GaussianState, camera: Camera,
               rendered_invdepth: torch.Tensor,
               radii: torch.Tensor) -> ViewTerms:
    """The projection of the centres, the validity filter and the two
    depths at each centre's pixel (shared by :func:`prune_view` and
    :func:`adjust_gaussians_to_depth`)."""
    w2c = camera.world_view
    cam_xyz = state.params.xyz @ w2c[:3, :3].T + w2c[:3, 3]
    cam_z = cam_xyz[:, 2]
    fx = camera.width / (2.0 * camera.tan_fovx)
    fy = camera.height / (2.0 * camera.tan_fovy)
    px = fx * cam_xyz[:, 0] / cam_z + camera.width / 2.0
    py = fy * cam_xyz[:, 1] / cam_z + camera.height / 2.0
    valid = ((px >= 0) & (px < camera.width)
             & (py >= 0) & (py < camera.height)
             & (cam_z > 0) & (radii > 0) & state.active)
    # Clamped in float before the cast: for cam_z <= 0 the coordinates are
    # +-inf or NaN, whose cast to int is undefined in torch (XLA
    # saturates). Such rows are invalid; their indices only stay in range.
    xi = torch.nan_to_num(px, nan=0.0).clamp(0, camera.width - 1).to(
        torch.int64)
    yi = torch.nan_to_num(py, nan=0.0).clamp(0, camera.height - 1).to(
        torch.int64)
    rend_inv = rendered_invdepth[0][yi, xi]
    if camera.invdepth is not None:
        mono = camera.invdepth[yi, xi]
    else:
        mono = torch.zeros_like(rend_inv)
    return ViewTerms(cam_xyz=cam_xyz, px=px, py=py, valid=valid,
                     rend_invdepth=rend_inv,
                     rend_depth=1.0 / (rend_inv + EPSILON),
                     mono_depth=1.0 / (mono + EPSILON))


def prune_view(state: GaussianState, opt_state: optim.AdamState,
               table: FeatureTable, camera: Camera,
               rendered_invdepth: torch.Tensor, radii: torch.Tensor,
               cam_extent: float, use_least_squares: bool = False):
    """One view of the floating-object pruner. Returns (state, opt_state,
    table, n_deleted) with n_deleted a 0-dim int32 tensor."""
    terms = view_terms(state, camera, rendered_invdepth, radii)
    pairs = torch.stack([terms.rend_depth, terms.cam_z], dim=1)
    table = update_table(table, pairs, terms.valid)
    if use_least_squares:
        in_tbl = torch.arange(table.data.shape[0],
                              device=table.data.device) < table.count
        k, b, _ = least_squares_fit(table.data[:, 0], table.data[:, 1],
                                    in_tbl)
    else:
        k, b = 1.0, 0.0  # the reference's override (GaussianOpt.py:303)
    norm_rend = k * terms.rend_depth + b
    norm_mono = k * terms.mono_depth + b
    scaling = state.get_scaling()
    max_radii3d = torch.max(scaling, dim=1).values
    geo_mean_radii = torch.prod(scaling, dim=1) ** (1.0 / 3.0)
    cam_z = terms.cam_z
    near = cam_z < NEAR_Z
    floating = (((norm_mono - norm_rend) > cam_extent) & near
                & ((cam_z - geo_mean_radii) < norm_rend))
    huge = near & (max_radii3d > MAX_RADII_WORLD)
    state, opt_state, n_del = densify_ops.prune_rows(
        state, opt_state, terms.valid & (floating | huge))
    return state, opt_state, table, n_del


RenderFn = Callable[[Camera, GaussianState], tuple]


def prune_loop(state: GaussianState, opt_state: optim.AdamState,
               cameras: Sequence[Camera], render_fn: RenderFn,
               cam_extent: float, rng: Optional[np.random.RandomState] = None,
               use_least_squares: bool = False, max_epochs: int = 1000):
    """Prune view after random view until ``len(cameras)`` views in total
    have deleted nothing, or ``max_epochs`` views (``train.py:229-291``).
    A view without a reliable prior counts as one that deleted nothing.
    `render_fn(camera, state)` returns (invdepth (1, H, W), radii (C,)).
    Returns (state, opt_state, {total_deleted, epochs, history}), history
    being the running total after each rendered view."""
    rng = rng or np.random.RandomState(0)
    table = FeatureTable.empty(device=state.active.device)
    zero_views = 0
    total_deleted = 0
    epochs = 0
    deletions = []
    while zero_views < len(cameras) and epochs < max_epochs:
        cam = cameras[rng.randint(len(cameras))]
        if cam.invdepth is None or not cam.depth_reliable:
            zero_views += 1
            epochs += 1
            continue
        invdepth, radii = render_fn(cam, state)
        state, opt_state, table, n_del = prune_view(
            state, opt_state, table, cam, invdepth, radii, cam_extent,
            use_least_squares=use_least_squares)
        n_del = int(n_del)
        total_deleted += n_del
        deletions.append(total_deleted)
        if n_del == 0:
            zero_views += 1
        epochs += 1
    return state, opt_state, {"total_deleted": total_deleted,
                              "epochs": epochs, "history": deletions}


def noise_draws(capacity: int, cam_extent: float, n_noise: int = 6,
                generator: Optional[torch.Generator] = None, device=None):
    """The random draws of :func:`inject_noise_gaussians`: positions in
    x, y uniform in [-2 cam_extent, cam_extent), opacity logits uniform in
    [4, 9) (sigmoid 0.98-1, ``train.py:207``) and the rows whose scales
    the floaters take."""
    u_xy = torch.rand((n_noise, 2), generator=generator, device=device)
    u_op = torch.rand((n_noise, 1), generator=generator, device=device)
    rows = torch.randint(0, capacity, (n_noise,), generator=generator,
                         device=device)
    return {"new_xy": -2.0 * cam_extent + u_xy * (3.0 * cam_extent),
            "new_op": 4.0 + u_op * 5.0, "rand_rows": rows}


def inject_noise_gaussians(state: GaussianState, opt_state: optim.AdamState,
                           cam_extent: float, n_noise: int = 6,
                           z_depth: float = 15.0, draws: Optional[dict] = None,
                           generator: Optional[torch.Generator] = None):
    """The reference's iteration-30000 experiment (``train.py:193-221``):
    `n_noise` bright Gaussians at z = `z_depth` in the first free slots,
    with the features and rotation of the nearest active Gaussian, and the
    scales of random rows. `draws` ({new_xy, new_op, rand_rows}, as
    :func:`noise_draws` returns them) or else draws from `generator`.
    Floaters beyond the free slots are dropped. Returns (state, opt_state,
    dst), dst the slots written (the capacity where dropped)."""
    c = state.capacity
    dev = state.active.device
    if draws is None:
        draws = noise_draws(c, cam_extent, n_noise, generator, dev)
    new_xy = torch.as_tensor(draws["new_xy"], dtype=torch.float32,
                             device=dev)
    new_op = torch.as_tensor(draws["new_op"], dtype=torch.float32,
                             device=dev)
    rand_rows = torch.as_tensor(draws["rand_rows"], dtype=torch.int64,
                                device=dev)
    new_xyz = torch.cat([new_xy, torch.full((n_noise, 1), z_depth,
                                            device=dev)], dim=1)

    # The nearest active Gaussian of each floater.
    d = new_xyz[:, None, :] - state.params.xyz[None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(state.active[None, :], d2,
                     torch.full_like(d2, float("inf")))
    closest = torch.argmin(d2, dim=1)

    free_slots = torch.sort(state.active.to(torch.uint8),
                            stable=True).indices[:n_noise]
    n_free = c - torch.sum(state.active.to(torch.int64))
    ok = torch.arange(n_noise, device=dev) < n_free
    dst = torch.where(ok, free_slots, torch.full_like(free_slots, c))

    p = state.params

    def put(leaf, values):
        return densify_ops._scatter_rows(leaf, dst, values)

    new_params = p.replace(
        xyz=put(p.xyz, new_xyz),
        features_dc=put(p.features_dc, p.features_dc[closest]),
        features_rest=put(p.features_rest, p.features_rest[closest]),
        opacity=put(p.opacity, new_op),
        scaling=put(p.scaling, p.scaling[rand_rows]),
        rotation=put(p.rotation, p.rotation[closest]))
    active = put(state.active, torch.ones(n_noise, dtype=torch.bool,
                                          device=dev))
    touched = put(torch.zeros(c, dtype=torch.bool, device=dev),
                  torch.ones(n_noise, dtype=torch.bool, device=dev))
    opt_state = optim.zero_moments_rows(opt_state, touched)
    return state.replace(params=new_params, active=active), opt_state, dst


def adjust_gaussians_to_depth(state: GaussianState, camera: Camera,
                              rendered_invdepth: torch.Tensor,
                              radii: torch.Tensor, cam_extent: float,
                              threshold_frac: float = 0.5):
    """The reference's alternative ``gs_adjustment`` (GaussianOpt.py:436-503):
    move each valid Gaussian whose rendered depth differs from the prior's
    by more than ``threshold_frac * cam_extent`` along its camera ray to
    the prior's depth, instead of deleting it. Not called by the trainer.
    Returns (state, number moved)."""
    terms = view_terms(state, camera, rendered_invdepth, radii)
    move = terms.valid & (torch.abs(terms.mono_depth - terms.rend_depth)
                          > threshold_frac * cam_extent)
    # The same ray, z from the prior.
    scale = terms.mono_depth / torch.clamp_min(terms.cam_z, EPSILON)
    new_cam = terms.cam_xyz * scale[:, None]
    w2c = camera.world_view
    cam_center = -w2c[:3, :3].T @ w2c[:3, 3]
    new_world = new_cam @ w2c[:3, :3] + cam_center
    xyz = torch.where(move[:, None], new_world, state.params.xyz)
    return (state.replace(params=state.params.replace(xyz=xyz)),
            torch.sum(move.to(torch.int32)))
