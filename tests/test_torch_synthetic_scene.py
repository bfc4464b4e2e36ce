"""The port's synthetic-scene generator (``make_synthetic_scene``) against
the repo's ``tools/make_synthetic_scene.py``: the same scene, byte for
byte, at 64², 3 views and 200 points, through ``main`` and through its
command line."""

import importlib.util
import os
import subprocess
import sys

import numpy as np

from priordepth_gaussiansplatting_torch import make_synthetic_scene as mss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tool():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_scene",
        os.path.join(REPO, "tools", "make_synthetic_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree(root: str) -> dict:
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def test_scene_bytes_equal_the_tool(tmp_path):
    tool().main(str(tmp_path / "tool"), 64, 3, n_points=200)
    mss.main(str(tmp_path / "port"), 64, 3, n_points=200)
    want, got = tree(str(tmp_path / "tool")), tree(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) == sorted(
        [f"images/r_{i:03d}.png" for i in range(3)]
        + [f"sparse/0/{s}.bin" for s in ("cameras", "images", "points3D")])
    assert got == want


def test_pose_and_render_equal_the_tool():
    ref = tool()
    for i in range(3):
        R, t = mss.camera_pose(i, 5)
        R0, t0 = ref.camera_pose(i, 5)
        np.testing.assert_array_equal(R, R0)
        np.testing.assert_array_equal(t, t0)
        for a, b in zip(mss.render_view(R, t, 16, 13.0),
                        ref.render_view(R0, t0, 16, 13.0)):
            np.testing.assert_array_equal(a, b)


def test_command_line(tmp_path):
    """``python -m priordepth_gaussiansplatting_torch.make_synthetic_scene
    OUT SIZE VIEWS``, as the chip smoke run starts it, writes the tool's
    scene of 8,000 points requested."""
    out = subprocess.run(
        [sys.executable, "-m",
         "priordepth_gaussiansplatting_torch.make_synthetic_scene",
         str(tmp_path / "port"), "24", "2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tool().main(str(tmp_path / "tool"), 24, 2)
    assert tree(str(tmp_path / "port")) == tree(str(tmp_path / "tool"))
    missing = subprocess.run(
        [sys.executable, "-m",
         "priordepth_gaussiansplatting_torch.make_synthetic_scene"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert missing.returncode != 0 and "Usage" in missing.stderr
