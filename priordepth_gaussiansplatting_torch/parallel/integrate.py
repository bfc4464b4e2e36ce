"""Sharded state around the multi-rank step: row permutations of the global
store, the split into per-rank shards and back, the shard-wise capacity
regrow, and the step, densify and opacity-reset functions over the mesh
(counterpart of the JAX package's ``parallel/integrate.py``).

A gauss rank's shard is the contiguous block of C / n_gauss rows that the
JAX package places on the matching device; the exposure table and the Adam
step count are replicated. Every data rank of a gauss column holds the same
shard.
"""

from __future__ import annotations

import torch

from ..models import densify as densify_ops
from ..models import gaussians as gm
from ..models.gaussians import PARAM_NAMES, GaussianParams, GaussianState
from ..train import optim
from ..train.optim import PER_GAUSSIAN
from ..train.step import TrainStepFns
from ..utils.config import OptimizationConfig, PipelineConfig
from . import step as pstep
from .mesh import GAUSS_AXIS, Mesh, all_gather_rows, psum

STAT_FIELDS = ("max_radii2d", "xyz_gradient_accum", "denom")
INFO_KEYS = ("n_cloned", "n_split", "n_pruned", "n_dropped", "n_active")


def _map_rows(state: GaussianState, opt_state: optim.AdamState, fn):
    """Apply `fn(leaf, fill)` to every per-Gaussian leaf of the state and
    of the Adam moments; `fill` is the leaf's padding value (False for the
    active mask, else 0)."""
    def params(p: GaussianParams) -> GaussianParams:
        return GaussianParams(**{k: fn(getattr(p, k), 0.0)
                                 if k in PER_GAUSSIAN else getattr(p, k)
                                 for k in PARAM_NAMES})

    state = state.replace(
        params=params(state.params), active=fn(state.active, False),
        **{k: fn(getattr(state, k), 0.0) for k in STAT_FIELDS})
    opt_state = optim.AdamState(mu=params(opt_state.mu),
                                nu=params(opt_state.nu),
                                count=opt_state.count)
    return state, opt_state


def _permute_rows(state, opt_state, perm):
    """Row permutation perm[dst] = src of every per-Gaussian leaf. Row order
    does not change the loss (the pairs are depth-sorted)."""
    perm = torch.as_tensor(perm, device=state.active.device)
    return _map_rows(state, opt_state, lambda x, _: x[perm])


def interleave_rows(state: GaussianState, opt_state: optim.AdamState,
                    n_gauss: int):
    """Spread the rows so that row i lands on shard i mod n_gauss:
    ``create_from_points`` packs the live rows at the front, which would
    leave the last shards empty."""
    c = state.capacity
    if n_gauss <= 1 or c % n_gauss != 0:
        return state, opt_state
    perm = torch.cat([torch.arange(k, c, n_gauss) for k in range(n_gauss)])
    return _permute_rows(state, opt_state, perm)


def compact_rows(state: GaussianState, opt_state: optim.AdamState):
    """Active rows first, inactive after, each in order (so that a later
    :func:`interleave_rows` balances the shards exactly)."""
    act = state.active
    perm = torch.cat([torch.nonzero(act)[:, 0], torch.nonzero(~act)[:, 0]])
    return _permute_rows(state, opt_state, perm)


def pad_capacity_to_multiple(state: GaussianState,
                             opt_state: optim.AdamState, n_gauss: int):
    """Round the capacity up to a multiple of n_gauss (padding rows as
    ``grow_capacity`` makes them, zero moments)."""
    c = state.capacity
    target = -(-c // n_gauss) * n_gauss
    if target == c:
        return state, opt_state
    state = gm.grow_capacity(state, target)

    def pad(x):
        return torch.cat([x, x.new_zeros((target - c,) + tuple(x.shape[1:]))])

    def padp(p: GaussianParams) -> GaussianParams:
        return GaussianParams(**{k: pad(getattr(p, k)) if k in PER_GAUSSIAN
                                 else getattr(p, k) for k in PARAM_NAMES})

    return state, optim.AdamState(mu=padp(opt_state.mu),
                                  nu=padp(opt_state.nu),
                                  count=opt_state.count)


def place_sharded(state: GaussianState, opt_state: optim.AdamState,
                  mesh: Mesh):
    """This rank's shard of the global state: rows [g C/n, (g+1) C/n) of
    every per-Gaussian leaf for gauss rank g, the rest as it is."""
    c, n = state.capacity, mesh.n_gauss
    if c % n:
        raise ValueError(f"capacity {c} is not a multiple of n_gauss {n}")
    local = c // n
    lo = mesh.gauss_rank * local
    return _map_rows(state, opt_state,
                     lambda x, _: x[lo:lo + local].clone())


def gather_sharded(state: GaussianState, opt_state: optim.AdamState,
                   mesh: Mesh):
    """The global state from the gauss group's shards (the inverse of
    :func:`place_sharded`), on every rank of the group."""
    def gather(x, _):
        if x.dtype == torch.bool:
            return all_gather_rows(x.to(torch.uint8), mesh,
                                   GAUSS_AXIS).to(torch.bool)
        return all_gather_rows(x, mesh, GAUSS_AXIS)
    with torch.no_grad():
        return _map_rows(state, opt_state, gather)


def grow_sharded(state: GaussianState, opt_state: optim.AdamState,
                 mesh: Mesh, occupancy_threshold: float = 0.85,
                 factor: int = 2):
    """Shard-wise capacity regrow: when the gauss group's active rows
    exceed `occupancy_threshold` of its capacity, each shard grows to
    `factor` times its rows, padded at its own end (so free slots stay
    balanced). Returns (state, opt_state, grown). Padding is zero, with
    unit quaternions where a rotation sums to zero, as in the JAX
    package."""
    n_active = int(psum(state.num_active, mesh, GAUSS_AXIS))
    local = state.capacity
    if n_active <= occupancy_threshold * local * mesh.n_gauss:
        return state, opt_state, False
    extra = local * (factor - 1)

    def grow(x, fill):
        return torch.cat([x, torch.full((extra,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    state, opt_state = _map_rows(state, opt_state, grow)
    rot = state.params.rotation
    unit = torch.zeros_like(rot)
    unit[:, 0] = 1.0
    rot = torch.where((rot.sum(-1) == 0)[:, None], unit, rot)
    return state.replace(params=state.params.replace(rotation=rot)), \
        opt_state, True


def fold_in(seed: int, mesh: Mesh) -> int:
    """The densify seed of this gauss rank (JAX folds the gauss rank into
    the key): distinct per rank, the same on every data rank."""
    return int(seed) * mesh.n_gauss + mesh.gauss_rank


def make_sharded_fns(opt_cfg: OptimizationConfig, pipe_cfg: PipelineConfig,
                     mesh: Mesh, use_trained_exp: bool = False,
                     tile_shard: bool = False,
                     pair_capacity: int | None = None) -> TrainStepFns:
    """TrainStepFns over the mesh: the sharded step (a camera batch in),
    shard-local densify and opacity reset.

    ``densify(state, opt_state, use_size_threshold=False, noise=None,
    seed=0)`` runs on this rank's shard: each shard fills its own free
    slots, split noise is `noise` ((2, C_local, 3) standard normals) or
    drawn from a generator seeded with :func:`fold_in` of `seed`, and the
    counts are summed over the gauss group. ``reset_opacity`` is
    elementwise on the shard."""
    step = pstep.make_sharded_train_step(
        opt_cfg, pipe_cfg, mesh, use_trained_exp=use_trained_exp,
        tile_shard=tile_shard, pair_capacity=pair_capacity)

    def densify(state, opt_state, use_size_threshold: bool = False,
                noise=None, seed: int = 0):
        generator = None
        if noise is None:
            generator = torch.Generator(device=state.active.device)
            generator.manual_seed(fold_in(seed, mesh))
        state, opt_state, info = densify_ops.densify_and_prune(
            state, opt_state, opt_cfg.densify_grad_threshold, 0.005,
            state.spatial_lr_scale, 20.0 if use_size_threshold else 0.0,
            percent_dense=opt_cfg.percent_dense, noise=noise,
            generator=generator)
        counts = psum(torch.stack([info[k].to(torch.int64)
                                   for k in INFO_KEYS]), mesh, GAUSS_AXIS)
        return state, opt_state, dict(zip(INFO_KEYS, counts))

    return TrainStepFns(step=step, densify=densify,
                        reset_opacity=densify_ops.reset_opacity)
