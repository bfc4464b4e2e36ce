"""Carry values from the JAX package into the port as numpy arrays, so both
compute the same thing on the same inputs, and the port's state back out to
numpy for comparison. Takes numpy (or anything ``np.asarray`` accepts) and
imports nothing of the JAX package.

For the multi-rank step: :func:`shard_numpy` cuts gauss rank g's shard out
of the global state (the rows the JAX package places on that device), and
:func:`unshard_numpy` puts the shards' arrays back together.

For the depth models: :func:`depth_module_from_numpy` loads a flax
parameter tree of the JAX package's ``depth/`` modules into the port's
module of the same geometry, and :func:`depth_params_to_numpy` gives a
port module's weights back as that tree."""

from __future__ import annotations

import numpy as np
import torch

from .core.cameras import Camera
from .depth.layers import SelfAttention
from .device import resolve_device
from .models.gaussians import PARAM_NAMES as PARAM_FIELDS
from .models.gaussians import GaussianParams, GaussianState
from .ops.projection import ProjectedGaussians
from .train.optim import PER_GAUSSIAN, AdamState

STAT_FIELDS = ("max_radii2d", "xyz_gradient_accum", "denom")
# Keys of the per-Gaussian arrays (first axis = capacity) in the dicts here.
ROW_KEYS = PER_GAUSSIAN + ("active",) + STAT_FIELDS


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
                      alpha_mask=None, pix_wh=None, tan_wh=None,
                      exposure_idx=None, device=None) -> Camera:
    """A Camera from the JAX camera's matrices and metadata."""
    device = resolve_device(device)

    def opt(x):
        return None if x is None else _f32(x, device)
    return Camera(
        world_view=_f32(world_view, device), full_proj=_f32(full_proj, device),
        cam_center=_f32(cam_center, device), image=opt(image),
        invdepth=opt(invdepth), depth_mask=opt(depth_mask),
        alpha_mask=opt(alpha_mask), pix_wh=opt(pix_wh), tan_wh=opt(tan_wh),
        exposure_idx=None if exposure_idx is None else torch.tensor(
            int(exposure_idx), dtype=torch.int32, device=device),
        height=int(height), width=int(width), fovx=float(fovx),
        fovy=float(fovy), exposure_id=int(exposure_id))


def camera_batch_from_numpy(width: int, height: int, fovx: float,
                            fovy: float, exposure_id: int = -1, device=None,
                            **arrays) -> list:
    """A camera batch (one Camera per data rank) from the JAX package's
    stacked batch: each of `arrays` (the array fields of
    :func:`camera_from_numpy`, None where absent) has a leading batch axis;
    the static fields are shared."""
    arrays = {k: v for k, v in arrays.items() if v is not None}
    n = len(np.asarray(arrays["world_view"]))
    return [camera_from_numpy(
        width=width, height=height, fovx=fovx, fovy=fovy,
        exposure_id=exposure_id, device=device,
        **{k: np.asarray(v)[i] for k, v in arrays.items()})
        for i in range(n)]


def shard_numpy(arrays: dict, n_gauss: int, gauss_rank: int) -> dict:
    """Gauss rank `gauss_rank`'s shard of a dict of global arrays: rows
    [g C/n, (g+1) C/n) of the per-Gaussian entries (``ROW_KEYS``), the rest
    as they are. Nested dicts (Adam's ``mu``/``nu``) are cut alike."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, dict):
            out[k] = shard_numpy(v, n_gauss, gauss_rank)
        elif k in ROW_KEYS:
            v = np.asarray(v)
            local = v.shape[0] // n_gauss
            out[k] = v[gauss_rank * local:(gauss_rank + 1) * local]
        else:
            out[k] = v
    return out


def unshard_numpy(shards: list) -> dict:
    """The inverse of :func:`shard_numpy`: the gauss ranks' dicts, in rank
    order, with the per-Gaussian entries concatenated."""
    out = {}
    for k, v in shards[0].items():
        if isinstance(v, dict):
            out[k] = unshard_numpy([s[k] for s in shards])
        elif k in ROW_KEYS:
            out[k] = np.concatenate([np.asarray(s[k]) for s in shards])
        else:
            out[k] = v
    return out


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


def _depth_leaf(path: tuple, value: np.ndarray):
    """(port parameter name, array in the port's layout) of one flax leaf
    at `path` (module names, then the leaf's): kernels (kh, kw, in, out) ->
    (out, in, kh, kw), (in, out) -> (out, in), the attention projections'
    (E, heads, d) and (heads, d, E) kernels and (heads, d) biases
    flattened; LayerNorm scales become weights; other leaves keep their
    names."""
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    if leaf == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 3 and parent in ("query", "key", "value"):
            value = value.reshape(value.shape[0], -1).T
        elif value.ndim == 3 and parent == "out":
            value = value.reshape(-1, value.shape[-1]).T
        else:
            value = value.T
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf == "bias" and parent in ("query", "key", "value"):
        value = value.reshape(-1)
    return ".".join([*mods, leaf]), np.ascontiguousarray(value)


def depth_state_dict_from_numpy(params: dict) -> dict:
    """{port parameter name: array} of a flax parameter tree of a JAX
    ``depth/`` module (a nested dict of arrays with flax's names, with or
    without the top-level ``params`` key)."""
    params = params.get("params", params)
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name, arr = _depth_leaf(path + (k,),
                                        np.asarray(v, dtype=np.float32))
                out[name] = arr
    walk(params, ())
    return out


def depth_module_from_numpy(params: dict, module: torch.nn.Module
                            ) -> torch.nn.Module:
    """`module` (a port ``depth/`` module of the same geometry) with the
    weights of a JAX module's flax tree, on the module's device. A leaf
    that the module lacks, a parameter that the tree lacks, or a shape
    that differs raises ValueError naming the leaf."""
    arrays = depth_state_dict_from_numpy(params)
    own = module.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise ValueError(f"parameter trees differ: the module's "
                         f"{missing} are missing from the flax tree, whose "
                         f"{extra} the module lacks")
    for name, arr in arrays.items():
        if tuple(own[name].shape) != arr.shape:
            raise ValueError(f"{name}: the flax leaf has shape {arr.shape}, "
                             f"the module's {tuple(own[name].shape)}")
    module.load_state_dict({k: torch.tensor(v)
                            for k, v in arrays.items()})
    return module


def _flax_leaf(leaf: str, mod: torch.nn.Module, parent,
               value: np.ndarray):
    """(flax leaf name, array in flax's layout) of the port parameter
    `leaf` of `mod` (whose parent module is `parent`): the inverse of
    :func:`_depth_leaf`."""
    attention = isinstance(parent, SelfAttention)
    if isinstance(mod, torch.nn.Conv2d) and leaf == "weight":
        return "kernel", value.transpose(2, 3, 1, 0)
    if isinstance(mod, torch.nn.Linear) and leaf == "weight":
        value = value.T
        if attention and mod is parent.out:
            return "kernel", value.reshape(parent.num_heads, -1,
                                           value.shape[-1])
        if attention:
            return "kernel", value.reshape(value.shape[0],
                                           parent.num_heads, -1)
        return "kernel", value
    if isinstance(mod, torch.nn.Linear) and attention and mod is not \
            parent.out:
        return leaf, value.reshape(parent.num_heads, -1)
    if isinstance(mod, torch.nn.LayerNorm) and leaf == "weight":
        return "scale", value
    return leaf, value


def depth_params_to_numpy(module: torch.nn.Module) -> dict:
    """The flax variables ``{"params": tree}`` of a port ``depth/`` module:
    nested dicts of float32 numpy arrays with flax's names and layouts
    (``kernel`` for convolution and dense weights, transposed back, the
    attention projections' as (E, heads, d) and (heads, d, E) with (heads,
    d) biases; ``scale`` for LayerNorm weights), which the JAX package's
    ``apply`` takes and :func:`depth_module_from_numpy` loads back."""
    tree: dict = {}
    mods = dict(module.named_modules())
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        mod = mods[".".join(path)]
        parent = mods[".".join(path[:-1])] if path else None
        key, arr = _flax_leaf(leaf, mod, parent,
                              p.detach().cpu().numpy().astype(np.float32))
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(arr)
    return {"params": tree}
