"""The port's ``data/depth_scale.py`` against the JAX package's on the
observed-plane scene of ``tests/test_depth_prior_e2e.py`` (rebuilt here):
cameras on an arc over a grid of points on the plane z = 0, each point's
2D observation in every view that sees it, and 16-bit mono inverse depths
that are an affine map of the true ones. The JSON values must agree within
1e-6 relative, and the port's Scene must load the aligned priors."""

import json
import os

import numpy as np
from PIL import Image

from priordepth_gaussiansplatting_torch.data import colmap as cm
from priordepth_gaussiansplatting_torch.data import dataset as ds
from priordepth_gaussiansplatting_torch.data.depth_scale import (
    make_depth_scale)
from priordepth_gaussiansplatting_tpu.data import depth_scale as jds

REL = 1e-6


def observed_plane_scene(root, n_views=4, size=48):
    """The e2e test's scene: a 12x12 grid of points on z = 0, cameras at
    z = -2.5 looking at the origin, mono inverse depth 0.5/z + 0.02."""
    rng = np.random.RandomState(0)
    for d in ("images", "depths", "sparse/0"):
        os.makedirs(f"{root}/{d}", exist_ok=True)
    focal = size / (2 * np.tan(0.4))
    cameras = {1: cm.ColmapCamera(1, "PINHOLE", size, size,
                                  np.array([focal, focal, size / 2,
                                            size / 2]))}
    gx, gy = np.meshgrid(np.linspace(-0.6, 0.6, 12),
                         np.linspace(-0.6, 0.6, 12))
    pts = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)
    colors = (rng.rand(len(pts), 3) * 255).astype(np.uint8)
    points = {i + 1: cm.ColmapPoint3D(i + 1, pts[i], colors[i], 0.1,
                                      np.zeros(0, np.int32),
                                      np.zeros(0, np.int32))
              for i in range(len(pts))}
    images = {}
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    for v in range(n_views):
        eye = np.array([0.3 * (v - 1.5), 0.1 * v, -2.5])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0, -1, 0], fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1)  # camera to world
        tvec = -R.T @ eye
        cam_pts = (R.T @ pts.T).T + tvec
        uv = cam_pts[:, :2] / cam_pts[:, 2:3] * focal + size / 2
        vis = ((uv[:, 0] >= 0) & (uv[:, 0] < size)
               & (uv[:, 1] >= 0) & (uv[:, 1] < size))
        ids = np.where(vis)[0]
        images[v + 1] = cm.ColmapImage(v + 1, cm.rotmat2qvec(R.T), tvec, 1,
                                       f"view_{v}.png", uv[ids],
                                       (ids + 1).astype(np.int64))
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(
            np.uint8)).save(f"{root}/images/view_{v}.png")
        dirs = np.stack([(xs - size / 2) / focal, (ys - size / 2) / focal,
                         np.ones_like(xs, np.float64)], axis=-1)
        tz = -eye[2] / (dirs @ R.T)[..., 2]
        mono = 0.5 / tz + 0.02
        Image.fromarray((np.clip(mono, 0, 1) * 65535).astype(
            np.uint16)).save(f"{root}/depths/view_{v}.png")
    cm.write_cameras_binary(cameras, f"{root}/sparse/0/cameras.bin")
    cm.write_images_binary(images, f"{root}/sparse/0/images.bin")
    cm.write_points3D_binary(points, f"{root}/sparse/0/points3D.bin")
    return root


def test_depth_scale_matches_jax_and_scene_loads_it(tmp_path):
    root = observed_plane_scene(str(tmp_path / "scene"))
    depths = os.path.join(root, "depths")
    path = os.path.join(root, "sparse", "0", "depth_params.json")
    want = jds.make_depth_scale(root, depths)
    with open(path) as f:
        want_json = json.load(f)
    got = make_depth_scale(root, depths, n_workers=2)
    with open(path) as f:
        got_json = json.load(f)
    assert got == got_json and want == want_json
    assert sorted(got) == sorted(want) == [f"view_{v}" for v in range(4)]
    for name, p in got.items():
        assert p["scale"] > 0 and np.isfinite(p["offset"]), p
        for key in ("scale", "offset"):
            w = want[name][key]
            assert abs(p[key] - w) <= REL * max(abs(w), 1e-12), (name, key)

    scene = ds.Scene(root, "", depths="depths", shuffle=False,
                     device="cpu")
    cam = scene.train_cameras[0]
    assert cam.invdepth is not None and cam.depth_reliable
    # The aligned prior at the centre reads the plane's 1/z, about 1/2.5.
    center = float(cam.invdepth[cam.height // 2, cam.width // 2])
    assert abs(center - 1.0 / 2.5) < 0.15, center


def test_depth_scale_skips_views_without_priors(tmp_path):
    """A view whose PNG is missing gets no entry, in both packages."""
    root = observed_plane_scene(str(tmp_path / "scene"), n_views=3)
    os.remove(os.path.join(root, "depths", "view_1.png"))
    want = jds.make_depth_scale(root, os.path.join(root, "depths"))
    got = make_depth_scale(root, os.path.join(root, "depths"))
    assert sorted(got) == sorted(want) == ["view_0", "view_2"]
