"""Model snapshots: ``point_cloud/iteration_<it>/point_cloud.ply`` (byte-
compatible with the JAX package and SIBR viewers); counterpart of the JAX
package's ``train/checkpoint.py`` snapshot functions. Training checkpoints
come with the training path."""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..data import ply as ply_io
from ..device import resolve_device
from ..models.gaussians import GaussianParams, GaussianState


def save_model_snapshot(model_path: str, iteration: int,
                        state: GaussianState) -> None:
    """Write the active rows as the Gaussian-model PLY."""
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
