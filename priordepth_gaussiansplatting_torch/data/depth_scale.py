"""Mono-depth → COLMAP scale alignment: produces `sparse/0/depth_params.json`
(copy of the JAX package's ``data/depth_scale.py``, over the port's
``data/colmap.py``).

Pure-numpy port of the reference `utils/make_depth_scale.py:8-92` (cv2/joblib
free): for each image, the COLMAP 3D points observed in it are transformed to
the view, their inverse depths robustly summarised (median + mean absolute
deviation), the mono inverse-depth map sampled (bilinear) at the observed
keypoints and summarised the same way, and the per-image affine
    scale  = s_colmap / s_mono
    offset = t_colmap − t_mono·scale
is written so that `inv_aligned = inv_mono·scale + offset` matches COLMAP's
inverse-depth distribution (consumed by `scene/cameras.py:60-78` — our
the port's data/dataset.py).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from . import colmap as cm


def _bilinear_sample(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Replicate-border bilinear sampling (cv2.remap INTER_LINEAR)."""
    h, w = img.shape
    x = np.clip(xy[:, 0], 0, w - 1)
    y = np.clip(xy[:, 1], 0, h - 1)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def image_depth_params(image_meta: cm.ColmapImage, camera: cm.ColmapCamera,
                       points3d_ordered: np.ndarray, depths_dir: str):
    """Per-image (scale, offset); returns None if the depth map is missing."""
    pts_idx = image_meta.point3D_ids
    mask = (pts_idx >= 0) & (pts_idx < len(points3d_ordered))
    pts_idx_v = pts_idx[mask]
    valid_xys = image_meta.xys[mask]
    pts = (points3d_ordered[pts_idx_v] if len(pts_idx_v)
           else np.zeros((1, 3)))

    R = cm.qvec2rotmat(image_meta.qvec)
    pts_cam = pts @ R.T + image_meta.tvec
    with np.errstate(divide="ignore"):
        invcolmap = 1.0 / pts_cam[..., 2]

    stem = os.path.splitext(image_meta.name)[0]
    depth_path = os.path.join(depths_dir, stem + ".png")
    if not os.path.exists(depth_path):
        return None
    with Image.open(depth_path) as dp:
        invmono_map = np.asarray(dp, np.float32)
    if invmono_map.ndim != 2:
        invmono_map = invmono_map[..., 0]
    invmono_map = invmono_map / (2 ** 16)
    s = invmono_map.shape[0] / camera.height
    maps = (valid_xys * s).astype(np.float32) if len(pts_idx_v) \
        else np.zeros((1, 2), np.float32)
    valid = ((maps[:, 0] >= 0) & (maps[:, 1] >= 0)
             & (maps[:, 0] < camera.width * s)
             & (maps[:, 1] < camera.height * s) & (invcolmap > 0))

    if valid.sum() > 10 and (invcolmap.max() - invcolmap.min()) > 1e-3:
        mv = maps[valid]
        ic = invcolmap[valid]
        im = _bilinear_sample(invmono_map, mv)
        t_colmap = np.median(ic)
        s_colmap = np.mean(np.abs(ic - t_colmap))
        t_mono = np.median(im)
        s_mono = np.mean(np.abs(im - t_mono))
        scale = float(s_colmap / s_mono) if s_mono > 0 else 0.0
        offset = float(t_colmap - t_mono * scale)
    else:
        scale, offset = 0.0, 0.0
    return {"image_name": stem, "scale": scale, "offset": offset}


def make_depth_scale(base_dir: str, depths_dir: str,
                     n_workers: int = 8) -> dict:
    """Compute + write `sparse/0/depth_params.json`; returns the dict."""
    sparse = os.path.join(base_dir, "sparse", "0")
    cameras, images, points3d = cm.read_model(sparse)
    pts_indices = np.array([p.id for p in points3d.values()])
    pts_xyzs = np.array([p.xyz for p in points3d.values()])
    ordered = np.zeros((pts_indices.max() + 1, 3))
    ordered[pts_indices] = pts_xyzs

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        results = list(ex.map(
            lambda key: image_depth_params(images[key],
                                           cameras[images[key].camera_id],
                                           ordered, depths_dir),
            images.keys()))
    depth_params = {r["image_name"]: {"scale": r["scale"],
                                      "offset": r["offset"]}
                    for r in results if r is not None}
    with open(os.path.join(sparse, "depth_params.json"), "w") as f:
        json.dump(depth_params, f, indent=2)
    return depth_params
