"""Densification (clone, split, prune, opacity reset) on the fixed-capacity
Gaussian store, with no change of shape (counterpart of the JAX package's
``models/densify.py``).

The JAX package's semantics, which follow the reference's adaptive density
control with masked scatters instead of reallocation:
  * clone/split select on grads = sum ||d mean2D (NDC)|| / visible count
    (0 where never visible) >= max_grad; split when the largest scale
    exceeds percent_dense * extent, else clone;
  * a split draws two samples from the Gaussian itself (rotated
    scale-stds); both children get scale / 1.6; one reuses the parent's
    slot. The draws are an argument, (2, C, 3) standard normals, or come
    from the given generator;
  * prune: opacity < min_opacity, and, when max_screen_size > 0, a largest
    scale above 0.1 * extent (the reference's screen-radius test never
    fires upstream and is matched as such);
  * free (inactive) slots go to the clone then split requests in index
    order; requests past the free capacity are dropped;
  * the Adam moments of pruned, new and split rows are zeroed, and the
    statistics of every row reset to zero after a round.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import transforms
from ..train.optim import PER_GAUSSIAN, AdamState, zero_moments_rows
from .gaussians import PARAM_NAMES, GaussianParams, GaussianState


def add_densification_stats(state: GaussianState, screen_grad: torch.Tensor,
                            radii: torch.Tensor, width: int,
                            height: int) -> GaussianState:
    """Accumulate per-Gaussian screen-gradient norms and visibility counts.

    `screen_grad` is d(loss)/d(mean2D) in pixels (the gradient of render()'s
    ``screen_offset``); it is scaled by (W/2, H/2) to the NDC convention the
    reference's 2e-4 threshold was tuned for."""
    vis = radii > 0
    ndc = torch.stack([screen_grad[:, 0] * (0.5 * width),
                       screen_grad[:, 1] * (0.5 * height)], dim=-1)
    norm = torch.linalg.vector_norm(ndc, dim=-1)
    return state.replace(
        max_radii2d=torch.where(vis, torch.maximum(
            state.max_radii2d, radii.to(torch.float32)), state.max_radii2d),
        xyz_gradient_accum=state.xyz_gradient_accum
        + torch.where(vis, norm, torch.zeros_like(norm)),
        denom=state.denom + vis.to(torch.float32))


def _scatter_rows(leaf: torch.Tensor, dst: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """leaf[dst[i]] = values[i] where dst[i] < C; the rest are dropped (they
    land in a scratch row past the end)."""
    c = leaf.shape[0]
    out = torch.cat([leaf, leaf[:1]])
    out[dst] = values
    return out[:c]


def densify_and_prune(state: GaussianState, opt_state: AdamState,
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size: float, percent_dense: float = 0.01,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """One adaptive-density round. Returns (state, opt_state, info), with
    info's counts as 0-dim int32 tensors on the state's device."""
    c = state.capacity
    p = state.params
    dev = p.xyz.device
    active = state.active
    scaling = state.get_scaling()
    max_scale = torch.max(scaling, dim=-1).values
    grads = torch.where(state.denom > 0,
                        state.xyz_gradient_accum
                        / torch.clamp_min(state.denom, 1.0),
                        torch.zeros_like(state.denom))

    high_grad = (grads >= max_grad) & active
    clone_mask = high_grad & (max_scale <= percent_dense * extent)
    split_mask = high_grad & (max_scale > percent_dense * extent)

    prune_mask = (state.get_opacity() < min_opacity) & active
    if max_screen_size and max_screen_size > 0:
        prune_mask = prune_mask | (active & (max_scale > 0.1 * extent))
    clone_mask = clone_mask & ~prune_mask
    split_mask = split_mask & ~prune_mask
    active = active & ~prune_mask

    # Free slots: inactive rows first, in index order.
    free_slots = torch.sort(active.to(torch.int32), stable=True).indices
    n_free = c - torch.sum(active.to(torch.int32))
    clone_rank = torch.cumsum(clone_mask.to(torch.int32), 0) - 1
    n_clone_req = torch.sum(clone_mask.to(torch.int32))
    split_rank = torch.cumsum(split_mask.to(torch.int32), 0) - 1 + n_clone_req
    clone_ok = clone_mask & (clone_rank < n_free)
    split_ok = split_mask & (split_rank < n_free)
    oob = torch.full_like(free_slots, c)
    clone_dst = torch.where(clone_ok, free_slots[clone_rank.clamp(0, c - 1)],
                            oob)
    split_dst = torch.where(split_ok, free_slots[split_rank.clamp(0, c - 1)],
                            oob)

    # Split children.
    if noise is None:
        noise = torch.randn((2, c, 3), generator=generator, device=dev)
    rot = transforms.quat_to_rotmat(transforms.normalize_quat(p.rotation))
    offs = torch.einsum("nij,knj->kni", rot, noise * scaling[None])
    child_xyz = p.xyz[None] + offs
    child_scaling = torch.log(torch.clamp_min(scaling / 1.6, 1e-12))

    new_params = {}
    for name in PARAM_NAMES:
        leaf = getattr(p, name)
        if name not in PER_GAUSSIAN:
            new_params[name] = leaf
            continue
        leaf = _scatter_rows(leaf, clone_dst, getattr(p, name))
        if name == "xyz":
            sib, inplace = child_xyz[1], child_xyz[0]
        elif name == "scaling":
            sib, inplace = child_scaling, child_scaling
        else:
            sib, inplace = getattr(p, name), None
        leaf = _scatter_rows(leaf, split_dst, sib)
        if inplace is not None:
            leaf = torch.where(split_ok[:, None], inplace, leaf)
        new_params[name] = leaf

    new_active = _scatter_rows(active, clone_dst, torch.ones_like(active))
    new_active = _scatter_rows(new_active, split_dst, torch.ones_like(active))

    touched = prune_mask | split_ok
    touched = _scatter_rows(touched, clone_dst, torch.ones_like(touched))
    touched = _scatter_rows(touched, split_dst, torch.ones_like(touched))
    opt_state = zero_moments_rows(opt_state, touched)

    zeros = torch.zeros(c, dtype=torch.float32, device=dev)
    new_state = state.replace(
        params=GaussianParams(**new_params), active=new_active,
        xyz_gradient_accum=zeros, denom=zeros.clone(),
        max_radii2d=zeros.clone())

    def count(mask):
        return torch.sum(mask.to(torch.int32))

    info = {
        "n_cloned": count(clone_ok),
        "n_split": count(split_ok),
        "n_pruned": count(prune_mask),
        "n_dropped": count(clone_mask & ~clone_ok)
        + count(split_mask & ~split_ok),
        "n_active": count(new_active),
    }
    return new_state, opt_state, info


def reset_opacity(state: GaussianState, opt_state: AdamState,
                  ceiling: float = 0.01):
    """Clamp the opacity activation to <= `ceiling` and reset its Adam
    moments (the reference's reset every 3000 iterations)."""
    op = torch.sigmoid(state.params.opacity)
    new_op = transforms.inverse_sigmoid(
        torch.clamp(torch.clamp_max(op, ceiling), 1e-7, 1.0 - 1e-7))
    opt_state = zero_moments_rows(
        opt_state, torch.ones(state.capacity, dtype=torch.bool,
                              device=op.device), only=("opacity",))
    return state.replace(params=state.params.replace(opacity=new_op)), \
        opt_state


def prune_rows(state: GaussianState, opt_state: AdamState,
               prune_mask: torch.Tensor):
    """Deactivate arbitrary rows (the depth-prior floating-object pruner's
    ``prune_points``). Returns (state, opt_state, rows pruned)."""
    mask = prune_mask & state.active
    opt_state = zero_moments_rows(opt_state, mask)
    return (state.replace(active=state.active & ~mask), opt_state,
            torch.sum(mask.to(torch.int32)))
