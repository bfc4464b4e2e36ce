"""Everything a cell's run is fed, made from the configuration and --seed:
camera poses, the Gaussian store, Adam's moments, target images and
inverse-depth priors. Each leaf, moment and view has a generator of its
own, seeded from (seed, name), so that any one of them can be made again
alone: the program and the reference receive the same bytes. Tensors are
made on the device, in float32, in a few large calls.

Nothing here imports the measured program.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def generator(seed: int, *key, device="cpu") -> torch.Generator:
    """A generator on `device` seeded from `seed` and `key`."""
    text = ":".join(str(k) for k in (seed,) + key).encode()
    value = int.from_bytes(hashlib.sha256(text).digest()[:8], "little")
    return torch.Generator(device).manual_seed(value >> 1)


def split(cfg: dict) -> tuple[list, list]:
    """Indices of the training and held-out views (every `llffhold`-th view
    is held out, as 3DGS's ``--eval``)."""
    hold = cfg["llffhold"]
    views = range(cfg["views"])
    return ([i for i in views if i % hold != 0],
            [i for i in views if i % hold == 0])


def poses(cfg: dict, seed: int) -> list:
    """One dict per view: COLMAP-style R (camera-to-world) and t
    (world-to-camera), fovx, fovy, width, height. Cameras sit on a ring (or
    an arc) around the scene's centre, looking at it, jittered from the
    seed."""
    cam = cfg["assumed"]["cameras"]
    w, h = cfg["width"], cfg["height"]
    focal = cfg["assumed"]["focal_px"]
    fovx = 2.0 * math.atan(w / (2.0 * focal))
    fovy = 2.0 * math.atan(h / (2.0 * focal))
    rng = np.random.default_rng(int.from_bytes(
        hashlib.sha256(f"{seed}:poses".encode()).digest()[:8], "little"))
    n = cfg["views"]
    arc = math.radians(cam["arc_degrees"])
    out = []
    for i in range(n):
        ang = (i / n if cam["arc_degrees"] >= 360 else i / max(n - 1, 1) - 0.5
               ) * arc
        centre = np.array([cam["radius"] * math.sin(ang), -cam["height"],
                           -cam["radius"] * math.cos(ang)])
        centre = centre + rng.normal(0.0, cam["jitter"], 3)
        look = np.array(cam["look_at"], np.float64) + rng.normal(
            0.0, cam["jitter"], 3)
        z = look - centre
        z /= np.linalg.norm(z)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        rot = np.stack([x, y, z], 1)
        out.append({"R": rot, "t": -rot.T @ centre, "centre": centre,
                    "fovx": fovx, "fovy": fovy, "width": w, "height": h,
                    "name": f"view_{i:04d}", "index": i})
    return out


def extent(pose_list: list) -> float:
    """3DGS's scene extent: 1.1 x the largest camera distance from the
    cameras' mean centre."""
    centres = np.stack([p["centre"] for p in pose_list])
    mid = centres.mean(0)
    return float(1.1 * np.linalg.norm(centres - mid, axis=1).max())


def leaf(cfg: dict, seed: int, name: str, device) -> torch.Tensor:
    """One parameter group of the store, in its storage space."""
    st = cfg["assumed"]["store"]
    n = cfg["gaussians"]
    k = (cfg["sh_degree"] + 1) ** 2
    g = generator(seed, "store", name, device=device)
    f32 = torch.float32
    core = int(round(n * st["core_share"]))
    if name == "xyz":
        d = torch.randn(n, 3, generator=g, device=device, dtype=f32)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        u = torch.rand(n, generator=g, device=device, dtype=f32)
        lo, hi = st["shell_radii"]
        r = torch.cat([st["core_radius"] * u[:core] ** (1.0 / 3.0),
                       lo + (hi - lo) * u[core:]])
        return d * r[:, None] + torch.tensor(st["centre"], dtype=f32,
                                             device=device)
    if name == "scaling":
        s = torch.randn(n, 3, generator=g, device=device, dtype=f32)
        base = torch.full((n, 1), math.log(st["scale_median_core"]),
                          dtype=f32, device=device)
        base[core:] = math.log(st["scale_median_shell"])
        return base + st["log_scale_sigma"] * s
    if name == "rotation":
        return torch.randn(n, 4, generator=g, device=device, dtype=f32)
    if name == "opacity":
        return (st["opacity_logit_mean"] + st["opacity_logit_sigma"]
                * torch.randn(n, 1, generator=g, device=device, dtype=f32))
    if name == "features_dc":
        return st["dc_sigma"] * torch.randn(n, 3, generator=g, device=device,
                                            dtype=f32)
    if name == "features_rest":
        return st["rest_sigma"] * torch.randn(n, 3 * (k - 1), generator=g,
                                              device=device, dtype=f32)
    raise KeyError(name)


def moment(cfg: dict, seed: int, which: str, name: str,
           like: torch.Tensor) -> torch.Tensor:
    """Adam's first (`mu`) or second (`nu`) moment of one group, shaped as
    `like`: mu ~ N(0, mu_sigma^2), nu = (uniform root)^2."""
    ad = cfg["assumed"]["adam"]
    g = generator(seed, "adam", which, name, device=like.device)
    if which == "mu":
        return ad["mu_sigma"] * torch.randn(like.shape, generator=g,
                                            device=like.device,
                                            dtype=like.dtype)
    lo, hi = ad["nu_root"]
    r = lo + (hi - lo) * torch.rand(like.shape, generator=g,
                                    device=like.device, dtype=like.dtype)
    return r * r


def _waves(cfg: dict, g: torch.Generator, channels: int, spec: dict,
           device) -> torch.Tensor:
    """`channels` low-frequency patterns: base + sum of `waves` sinusoids of
    random amplitude, frequency (cycles per image) and phase."""
    h, w = cfg["height"], cfg["width"]
    k = spec["waves"]
    amp = spec["amplitude"] * torch.rand(channels, k, generator=g,
                                         device=device)
    fx = spec["cycles"] * (2.0 * torch.rand(channels, k, generator=g,
                                            device=device) - 1.0)
    fy = spec["cycles"] * (2.0 * torch.rand(channels, k, generator=g,
                                            device=device) - 1.0)
    ph = 2.0 * math.pi * torch.rand(channels, k, generator=g, device=device)
    y = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    x = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    out = torch.full((channels, h, w), spec["base"], device=device)
    for c in range(channels):
        for j in range(k):
            out[c] += amp[c, j] * torch.sin(2.0 * math.pi * (fx[c, j] * x
                                                             + fy[c, j] * y)
                                            + ph[c, j])
    return out.clamp_(spec["low"], spec["high"])


def target(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """The (3, H, W) target image of view `index`."""
    g = generator(seed, "target", index, device=device)
    return _waves(cfg, g, 3, cfg["assumed"]["targets"], device)


def prior(cfg: dict, seed: int, index: int, device):
    """The (H, W) inverse-depth prior of view `index`, or None when the
    configuration trains without one."""
    if not cfg["depth_prior"]:
        return None
    g = generator(seed, "prior", index, device=device)
    return _waves(cfg, g, 1, cfg["assumed"]["priors"], device)[0]


def small_cloud(seed: int, n: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """A tiny point cloud to construct the trainer on (its store is then
    replaced by the seeded one)."""
    rng = np.random.default_rng(seed & 0xFFFFFFFF)
    return (rng.normal(0.0, 0.5, (n, 3)).astype(np.float32),
            rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32))
