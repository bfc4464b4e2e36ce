"""Persistence (counterpart of the JAX package's ``train/checkpoint.py``):

  1. training checkpoint, ``chkpnt<iter>.pkl``: the pickled dict of numpy
     arrays the JAX package writes, with the same keys, so a checkpoint
     written by either package loads in the other (reference
     ``torch.save((capture(), it))``, ``train.py:340-342``);
  2. model snapshot, ``point_cloud/iteration_<it>/point_cloud.ply``
     (byte-compatible with SIBR viewers; active rows only) and
     ``exposure.json`` (reference ``scene/__init__.py:85-94``).
"""

from __future__ import annotations

import json
import os
import pickle
import re

import numpy as np
import torch

from ..data import ply as ply_io
from ..device import resolve_device
from ..models import gaussians as gm
from ..models.gaussians import PARAM_NAMES, GaussianParams, GaussianState
from . import optim

# Fills of padding rows: finite activations (an all-zero quaternion
# normalises to NaN), as create_from_points and grow_capacity write them.
PARAM_FILLS = {"scaling": float(np.log(1e-6)), "opacity": -6.0}
STAT_NAMES = ("max_radii2d", "xyz_gradient_accum", "denom")


def dataclass_to_dict(params: GaussianParams) -> dict:
    return {k: getattr(params, k) for k in PARAM_NAMES}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_checkpoint(path: str, state: GaussianState,
                    opt_state: optim.AdamState, iteration: int,
                    compact: bool = False) -> None:
    """Pickle the whole training state. compact=True stores only the
    active rows (and the capacity, which :func:`load_checkpoint` pads back
    to)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    idx = torch.nonzero(state.active).flatten() if compact else None

    def rows(x):
        return _np(x if idx is None else x.index_select(0, idx))

    def tree(p: GaussianParams) -> dict:
        return {k: (_np(v) if k == "exposure" else rows(v))
                for k, v in dataclass_to_dict(p).items()}

    state_d = {"params": tree(state.params)}
    if not compact:
        state_d["active"] = _np(state.active)
    state_d.update({k: rows(getattr(state, k)) for k in STAT_NAMES})
    state_d["active_sh_degree"] = np.asarray(state.active_sh_degree,
                                             np.int32)
    payload = {
        "iteration": int(iteration),
        "spatial_lr_scale": float(state.spatial_lr_scale),
        "max_sh_degree": int(state.max_sh_degree),
        "state": state_d,
        "opt": {"mu": tree(opt_state.mu), "nu": tree(opt_state.nu),
                "count": _np(opt_state.count).astype(np.int32)},
    }
    if compact:
        payload["compact_capacity"] = state.capacity
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def _flat_features(d: dict) -> dict:
    """Legacy (N, K, 3) feature leaves as the flat (N, 3K) layout."""
    out = dict(d)
    for k in ("features_dc", "features_rest"):
        v = np.asarray(out[k])
        if v.ndim == 3:
            out[k] = v.reshape(v.shape[0], -1)
    return out


def _pad_rows(x, cap: int, fill: float = 0.0) -> np.ndarray:
    x = np.asarray(x)
    widths = [(0, cap - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, widths, constant_values=fill)


def _pad_tree(d: dict, cap: int, param_fills: bool) -> dict:
    out = {}
    for k, v in d.items():
        v = np.asarray(v)
        if k == "exposure":
            out[k] = v
        elif param_fills and k == "rotation":
            pad = np.zeros((cap - v.shape[0], 4), v.dtype)
            pad[:, 0] = 1.0
            out[k] = np.concatenate([v, pad])
        else:
            out[k] = _pad_rows(v, cap, PARAM_FILLS.get(k, 0.0)
                               if param_fills else 0.0)
    return out


def load_checkpoint(path: str, device=None):
    """(state, opt_state, iteration) from a checkpoint of either package,
    on `device` (the card unless the caller names the CPU). A compact
    checkpoint is padded back to its capacity with the padding fills."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        p = pickle.load(f)
    s, o = p["state"], p["opt"]
    if "compact_capacity" in p:
        cap = int(p["compact_capacity"])
        n = np.asarray(s["params"]["xyz"]).shape[0]
        s = dict(s, params=_pad_tree(s["params"], cap, True),
                 active=np.arange(cap) < n,
                 **{k: _pad_rows(s[k], cap) for k in STAT_NAMES})
        o = dict(o, mu=_pad_tree(o["mu"], cap, False),
                 nu=_pad_tree(o["nu"], cap, False))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def params(d: dict) -> GaussianParams:
        return GaussianParams(**{k: t(v) for k, v in
                                 _flat_features(d).items()})

    state = GaussianState(
        params=params(s["params"]), active=t(s["active"], torch.bool),
        active_sh_degree=int(np.asarray(s["active_sh_degree"])),
        max_sh_degree=int(p["max_sh_degree"]),
        spatial_lr_scale=float(p["spatial_lr_scale"]),
        **{k: t(s[k]) for k in STAT_NAMES})
    opt_state = optim.AdamState(mu=params(o["mu"]), nu=params(o["nu"]),
                                count=t(o["count"], torch.int32))
    return state, opt_state, int(p["iteration"])


def maybe_grow(state: GaussianState, opt_state: optim.AdamState,
               occupancy_threshold: float = 0.85, factor: int = 2):
    """Double the store (and the Adam moments, with zero rows) when more
    than `occupancy_threshold` of it is active. Returns (state, opt_state,
    grew). Reads the active count back to the host."""
    if int(state.num_active) <= occupancy_threshold * state.capacity:
        return state, opt_state, False
    new_cap = state.capacity * factor
    state = gm.grow_capacity(state, new_cap)

    def grow(p: GaussianParams) -> GaussianParams:
        return GaussianParams(**{
            k: v if k == "exposure" else torch.cat(
                [v, v.new_zeros((new_cap - v.shape[0],) + v.shape[1:])])
            for k, v in dataclass_to_dict(p).items()})

    return (state, optim.AdamState(mu=grow(opt_state.mu),
                                   nu=grow(opt_state.nu),
                                   count=opt_state.count), True)


def save_model_snapshot(model_path: str, iteration: int,
                        state: GaussianState, image_names=None) -> None:
    """Write the active rows as the Gaussian-model PLY and, given the
    {image name: exposure index} map, ``<model>/exposure.json``."""
    out_dir = os.path.join(model_path, "point_cloud",
                           f"iteration_{iteration}")
    active = state.active.cpu().numpy()
    p = state.params

    def rows(t):
        return t.detach().cpu().numpy()[active]

    ply_io.save_gaussian_ply(
        os.path.join(out_dir, "point_cloud.ply"), rows(p.xyz),
        rows(p.features_dc), rows(p.features_rest), rows(p.opacity),
        rows(p.scaling), rows(p.rotation))
    if image_names:
        exposure = _np(p.exposure)
        table = {name: exposure[i].tolist()
                 for name, i in image_names.items()
                 if i < exposure.shape[0]}
        with open(os.path.join(model_path, "exposure.json"), "w") as f:
            json.dump(table, f, indent=2)


def latest_iteration(model_path: str) -> int:
    pc_dir = os.path.join(model_path, "point_cloud")
    return max(int(m.group(1)) for d in os.listdir(pc_dir)
               if (m := re.match(r"iteration_(\d+)$", d)))


def load_model_snapshot(model_path: str, iteration: int = -1,
                        max_sh_degree: int = 3, capacity: int | None = None,
                        device=None) -> GaussianState:
    """Load a saved PLY into a GaussianState on `device` (the card unless
    the caller names the CPU). Rows past the file's are padding with the
    JAX package's fills: scaling log(1e-6), opacity -6, identity quats."""
    device = resolve_device(device)
    if iteration == -1:
        iteration = latest_iteration(model_path)
    d = ply_io.load_gaussian_ply(os.path.join(
        model_path, "point_cloud", f"iteration_{iteration}",
        "point_cloud.ply"))
    n = d["xyz"].shape[0]
    if capacity is None:
        capacity = int(2 ** np.ceil(np.log2(max(n, 1024))))
    capacity = max(capacity, n)

    def pad(x, fill=0.0):
        widths = [(0, capacity - n)] + [(0, 0)] * (x.ndim - 1)
        return torch.as_tensor(np.pad(x, widths, constant_values=fill),
                               device=device)

    rotation = np.concatenate(
        [d["rotation"], np.tile(np.array([[1, 0, 0, 0]], np.float32),
                                (capacity - n, 1))])
    params = GaussianParams(
        xyz=pad(d["xyz"]),
        features_dc=pad(d["features_dc"]),
        features_rest=pad(d["features_rest"]),
        scaling=pad(d["scaling"], np.log(1e-6)),
        rotation=torch.as_tensor(rotation, device=device),
        opacity=pad(d["opacity"], -6.0),
        exposure=torch.eye(3, 4, device=device)[None],
    )
    return GaussianState(params=params,
                         active=torch.arange(capacity, device=device) < n,
                         active_sh_degree=max_sh_degree,
                         max_sh_degree=max_sh_degree)
