"""The render slice end to end: a JAX GaussianState carried into the port,
port eval_image vs JAX eval_image(backend="pallas") on the CPU, and the
port's render CLI vs the root render.py on one saved model."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.train import step as pstep
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.core import transforms as jtr
from priordepth_gaussiansplatting_tpu.data import ply as jply
from priordepth_gaussiansplatting_tpu.models.gaussians import (GaussianParams,
                                                               GaussianState)
from priordepth_gaussiansplatting_tpu.train import step as jstep
from priordepth_gaussiansplatting_tpu.utils import config as jcfg
from priordepth_gaussiansplatting_tpu.utils import testing as JT
from tests.test_data import _make_blender_scene

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stored_params(seed, n, n_exposures=3):
    """GaussianParams fields (storage spaces) as numpy, SH degree 3."""
    g = PT.random_gaussians(seed, n, scale_range=(0.02, 0.12))
    rng = np.random.default_rng(seed + 1)
    exposure = np.tile(np.eye(3, 4, dtype=np.float32), (n_exposures, 1, 1))
    exposure += 0.05 * rng.standard_normal(exposure.shape).astype(np.float32)
    return {
        "xyz": g["means"],
        "features_dc": g["sh"][:, :3],
        "features_rest": g["sh"][:, 3:],
        "scaling": np.log(g["scales"]),
        "rotation": g["quats"],
        "opacity": np.asarray(jtr.inverse_sigmoid(
            jnp.asarray(g["opacities"])))[:, None],
        "exposure": exposure,
    }


@pytest.mark.parametrize("sh_degree", [0, 1, 3])
def test_gaussian_state_activations_match_jax(sh_degree):
    n = 64
    params = stored_params(13, n)
    active = np.arange(n) % 5 != 0
    state_j = GaussianState(
        params=GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        active=jnp.asarray(active), max_radii2d=jnp.zeros(n),
        xyz_gradient_accum=jnp.zeros(n), denom=jnp.zeros(n),
        active_sh_degree=jnp.asarray(sh_degree, jnp.int32), max_sh_degree=3)
    state = interop.gaussian_state_from_numpy(params, active, sh_degree, 3,
                                              device="cpu")
    for name in ("get_scaling", "get_opacity", "get_rotation",
                 "get_covariance", "get_features"):
        np.testing.assert_allclose(getattr(state, name)().numpy(),
                                   np.asarray(getattr(state_j, name)()),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(state.get_exposure(2).numpy(),
                                  np.asarray(state_j.get_exposure(2)))


def test_eval_image_matches_jax():
    n, wh = 256, 96
    params = stored_params(31, n)
    active = np.random.default_rng(3).random(n) > 0.15
    state_j = GaussianState(
        params=GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        active=jnp.asarray(active),
        max_radii2d=jnp.zeros(n), xyz_gradient_accum=jnp.zeros(n),
        denom=jnp.zeros(n), active_sh_degree=jnp.asarray(3, jnp.int32),
        max_sh_degree=3)
    target = np.random.default_rng(4).random((3, wh, wh)).astype(np.float32)
    cam_j = JT.look_at_camera((0.3, -0.2, -2.5), width=wh, height=wh,
                              image=target, exposure_id=1)
    bg = np.array([0.2, 0.1, 0.0], np.float32)
    want = jstep.eval_image(cam_j, state_j, jnp.asarray(bg),
                            antialiasing=True, use_trained_exp=True,
                            backend="pallas")

    state = interop.gaussian_state_from_numpy(params, active, 3, 3,
                                              device="cpu")
    cam = interop.camera_from_numpy(
        np.asarray(cam_j.world_view), np.asarray(cam_j.full_proj),
        np.asarray(cam_j.cam_center), wh, wh, cam_j.fovx, cam_j.fovy,
        image=target, exposure_id=1, device="cpu")
    got = pstep.eval_image(cam, state, torch.from_numpy(bg),
                           antialiasing=True, use_trained_exp=True,
                           backend="kernels")
    assert int(got["overflow"]) == int(want["overflow"]) == 0
    diff = np.abs(got["render"].numpy() - np.asarray(want["render"]))
    # bf16 tie flips in projection move a few pixels by ~1e-4.
    assert diff.max() <= 1e-3, diff.max()
    assert (diff <= 2e-5).mean() >= 0.999, (diff <= 2e-5).mean()
    assert abs(float(got["psnr"]) - float(want["psnr"])) <= 1e-3
    assert abs(float(got["l1"]) - float(want["l1"])) <= 1e-5
    # the dense oracle agrees with the tile pipeline
    oracle = pstep.eval_image(cam, state, torch.from_numpy(bg),
                              antialiasing=True, use_trained_exp=True,
                              backend="oracle")
    np.testing.assert_allclose(oracle["render"].numpy(),
                               got["render"].numpy(), atol=2e-5)


def test_render_cli_matches_root_render(tmp_path):
    root = str(tmp_path / "scene")
    mdir = str(tmp_path / "model")
    _make_blender_scene(root, n_frames=2, size=32)
    params = stored_params(41, 200)
    jply.save_gaussian_ply(
        os.path.join(mdir, "point_cloud", "iteration_7", "point_cloud.ply"),
        params["xyz"], params["features_dc"], params["features_rest"],
        params["opacity"], params["scaling"], params["rotation"])
    jcfg.save_cfg_args(mdir, jcfg.ModelConfig(
        source_path=root, model_path=mdir, white_background=True))

    import render as root_render
    root_render.main(["-m", mdir, "--skip_test"])
    jax_dir = os.path.join(mdir, "train", "ours_7", "renders")
    jax_pngs = {f: np.asarray(Image.open(os.path.join(jax_dir, f)), np.int16)
                for f in sorted(os.listdir(jax_dir))}
    os.rename(os.path.join(mdir, "train"), os.path.join(mdir, "train_jax"))

    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-m",
                    "priordepth_gaussiansplatting_torch.render", "-m", mdir,
                    "--data_device", "cpu", "--backend", "kernels",
                    "--skip_test"], cwd=REPO, env=env, check=True,
                   timeout=300)
    port_dir = os.path.join(mdir, "train", "ours_7", "renders")
    assert sorted(os.listdir(port_dir)) == list(jax_pngs) and len(jax_pngs) == 2
    for name, want in jax_pngs.items():
        got = np.asarray(Image.open(os.path.join(port_dir, name)), np.int16)
        assert got.shape == want.shape == (32, 32, 3)
        diff = np.abs(got - want)
        assert (diff <= 1).mean() >= 0.999, name
        assert got.std() > 0
    assert len(os.listdir(os.path.join(mdir, "train", "ours_7", "gt"))) == 2
