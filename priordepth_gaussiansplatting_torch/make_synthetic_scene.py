"""Generate a lego-class synthetic COLMAP dataset by raycasting (the
port's copy of the repo's ``tools/make_synthetic_scene.py``, writing through
the port's own ``data/colmap.py``; its images and model files are the same
bytes).

A textured scene (striped+checkered sphere resting on a checkerboard ground
plane, second satellite sphere, sky gradient) is raycast from an orbit of
cameras and written in the COLMAP layout the loader consumes
(`images/ + sparse/0/{cameras,images,points3D}.bin`), with an SfM-like
sparse point cloud sampled from true surface hits. Views are 3-D consistent
by construction, so a correct splatting trainer must be able to reach high
test PSNR.

Usage: python -m priordepth_gaussiansplatting_torch.make_synthetic_scene
       <out_dir> [size] [n_views]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _normalize(v, axis=-1):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


SPHERES = [
    # (center, radius)
    (np.array([0.0, 0.38, 0.0]), 0.38),
    (np.array([0.55, 0.16, 0.35]), 0.16),
    (np.array([-0.5, 0.12, -0.3]), 0.12),
    (np.array([0.32, 0.1, -0.45]), 0.10),
    (np.array([-0.28, 0.09, 0.5]), 0.09),
    (np.array([0.75, 0.08, -0.15]), 0.08),
    (np.array([-0.75, 0.11, 0.12]), 0.11),
    (np.array([0.05, 0.07, 0.72]), 0.07),
]
LIGHT = _normalize(np.array([0.4, 1.0, 0.25]))


def _sphere_color(i, p, c, r):
    d = _normalize(p - c)
    phi = np.arctan2(d[..., 0], d[..., 2])
    theta = np.arccos(np.clip(d[..., 1], -1, 1))
    if i == 0:
        stripes = 0.5 + 0.5 * np.sin(10 * phi) * np.sin(7 * theta)
        base = np.stack([0.85 * stripes + 0.1,
                         0.25 + 0.5 * (1 - stripes),
                         0.3 + 0.2 * np.sin(4 * phi)], -1)
        # high-frequency speckle overlay: detail that only densified,
        # small splats can represent
        spec = 0.12 * np.sin(37 * phi) * np.sin(29 * theta)
        base = base + spec[..., None]
    elif i == 1:
        check = ((np.floor(phi * 3 / np.pi) + np.floor(theta * 6 / np.pi))
                 % 2)
        base = np.stack([0.2 + 0.6 * check, 0.7 - 0.4 * check,
                         0.25 + 0.1 * check], -1)
    else:
        # deterministic per-index palette + fine stripes/checks
        f1, f2 = 11 + 6 * i, 7 + 4 * i
        u = 0.5 + 0.5 * np.sin(f1 * phi) * np.cos(f2 * theta)
        v = ((np.floor(phi * (2 + i) / np.pi)
              + np.floor(theta * (3 + i) / np.pi)) % 2)
        cols = np.array([[0.9, 0.7, 0.15], [0.2, 0.75, 0.85],
                         [0.85, 0.3, 0.5], [0.35, 0.85, 0.3],
                         [0.8, 0.45, 0.2], [0.5, 0.4, 0.9]])
        a = cols[i % len(cols)]
        b = cols[(i + 3) % len(cols)]
        base = (u[..., None] * a + (1 - u[..., None]) * b
                + 0.15 * (v[..., None] - 0.5))
    return base


def _ground_color(p):
    check = ((np.floor(p[..., 0] / 0.25) + np.floor(p[..., 2] / 0.25)) % 2)
    # fine sub-check grain (1/16 scale) modulates each cell
    fine = ((np.floor(p[..., 0] / 0.0625) + np.floor(p[..., 2] / 0.0625))
            % 2) * 0.12 - 0.06
    warm = np.stack([0.75 + 0 * check, 0.55 + 0 * check, 0.35 + 0 * check],
                    -1)
    cool = np.stack([0.25 + 0 * check, 0.3 + 0 * check, 0.4 + 0 * check], -1)
    return np.where(check[..., None] > 0, warm, cool) + fine[..., None]


def _sky_color(d):
    t = np.clip(0.5 * (d[..., 1] + 1.0), 0, 1)[..., None]
    return (1 - t) * np.array([0.9, 0.9, 0.95]) + t * np.array([0.3, 0.5, 0.9])


def raycast(origins, dirs):
    """Shade rays: returns (..., 3) colors, (...,) depth (inf for sky),
    (..., 3) hit points."""
    tbest = np.full(dirs.shape[:-1], np.inf)
    color = _sky_color(dirs)
    hitp = np.zeros_like(dirs)
    normal = np.zeros_like(dirs)

    # ground plane y=0 within |x|,|z| <= 1.5
    dy = dirs[..., 1]
    tg = np.where(np.abs(dy) > 1e-8, -origins[..., 1] / dy, np.inf)
    pg = origins + tg[..., None] * dirs
    okg = (tg > 1e-4) & (np.abs(pg[..., 0]) < 1.5) & (np.abs(pg[..., 2]) < 1.5)
    upd = okg & (tg < tbest)
    tbest = np.where(upd, tg, tbest)
    gcol = _ground_color(pg)
    color = np.where(upd[..., None], gcol, color)
    hitp = np.where(upd[..., None], pg, hitp)
    normal = np.where(upd[..., None], np.array([0.0, 1.0, 0.0]), normal)

    for i, (c, r) in enumerate(SPHERES):
        oc = origins - c
        b = np.sum(oc * dirs, -1)
        cq = np.sum(oc * oc, -1) - r * r
        disc = b * b - cq
        ok = disc > 0
        ts = -b - np.sqrt(np.maximum(disc, 0))
        ok &= ts > 1e-4
        upd = ok & (ts < tbest)
        tbest = np.where(upd, ts, tbest)
        ps = origins + ts[..., None] * dirs
        scol = _sphere_color(i, ps, c, r)
        color = np.where(upd[..., None], scol, color)
        hitp = np.where(upd[..., None], ps, hitp)
        normal = np.where(upd[..., None], _normalize(ps - c), normal)

    hit = np.isfinite(tbest)
    lam = np.clip(np.sum(normal * LIGHT, -1), 0, 1)
    shade = (0.35 + 0.65 * lam)[..., None]
    color = np.where(hit[..., None], color * shade, color)
    return np.clip(color, 0, 1), tbest, hitp


def camera_pose(i, n):
    """World-to-camera (R, t), COLMAP convention (x right, y down, z fwd)."""
    theta = 2 * np.pi * i / n
    elev = 0.55 + 0.25 * np.sin(3 * theta)   # vary elevation
    radius = 1.9
    eye = np.array([radius * np.sin(theta), elev, radius * np.cos(theta)])
    target = np.array([0.0, 0.28, 0.0])
    fwd = _normalize(target - eye)
    right = _normalize(np.cross(fwd, np.array([0.0, 1.0, 0.0])))
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], 0)      # rows = camera axes
    t = -R @ eye
    return R, t


def render_view(R, t, size, focal):
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)
    cx = cy = size / 2.0
    d_cam = np.stack([(xs - cx) / focal, (ys - cy) / focal,
                      np.ones_like(xs)], -1)
    d_world = _normalize(d_cam @ R)          # R^T rows applied
    eye = -R.T @ t
    origins = np.broadcast_to(eye, d_world.shape)
    return raycast(origins, d_world)


def main(out, size=256, n_views=32, n_points=8000, seed=0):
    from PIL import Image

    from .data import colmap as cm

    rng = np.random.RandomState(seed)
    os.makedirs(f"{out}/images", exist_ok=True)
    os.makedirs(f"{out}/sparse/0", exist_ok=True)
    focal = 0.82 * size
    cams = {1: cm.ColmapCamera(id=1, model="PINHOLE", width=size,
                               height=size,
                               params=np.array([focal, focal,
                                                size / 2.0, size / 2.0]))}
    images = {}
    pts_xyz, pts_rgb = [], []
    for i in range(n_views):
        R, t = camera_pose(i, n_views)
        color, depth, hitp = render_view(R, t, size, focal)
        name = f"r_{i:03d}.png"
        Image.fromarray((color * 255).astype(np.uint8)).save(
            f"{out}/images/{name}")
        images[i + 1] = cm.ColmapImage(
            id=i + 1, qvec=cm.rotmat2qvec(R), tvec=t, camera_id=1,
            name=name, xys=np.zeros((0, 2)),
            point3D_ids=np.zeros((0,), np.int64))
        # SfM-like sparse points: surface hits at random pixels.
        hit = np.isfinite(depth)
        ys, xs = np.nonzero(hit)
        take = rng.choice(len(ys), size=min(n_points // n_views, len(ys)),
                          replace=False)
        pts_xyz.append(hitp[ys[take], xs[take]])
        pts_rgb.append(color[ys[take], xs[take]])
        print(f"view {i}: hit {hit.mean():.2f}", flush=True)
    xyz = np.concatenate(pts_xyz)
    rgb = (np.concatenate(pts_rgb) * 255).astype(np.uint8)
    # SfM noise on point positions
    xyz = xyz + 0.003 * rng.standard_normal(xyz.shape)
    points = {
        j + 1: cm.ColmapPoint3D(
            id=j + 1, xyz=xyz[j], rgb=rgb[j], error=0.5,
            image_ids=np.array([1], np.int32),
            point2D_idxs=np.array([0], np.int32))
        for j in range(len(xyz))
    }
    cm.write_cameras_binary(cams, f"{out}/sparse/0/cameras.bin")
    cm.write_images_binary(images, f"{out}/sparse/0/images.bin")
    cm.write_points3D_binary(points, f"{out}/sparse/0/points3D.bin")
    print(f"wrote {n_views} views @{size}px, {len(xyz)} sparse points -> "
          f"{out}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    out = sys.argv[1]
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    nv = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    main(out, size, nv)
