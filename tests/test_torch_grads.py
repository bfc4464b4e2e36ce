"""Gradients through the port's rasterizer (plain K2, K3, K5b and K4 behind
the same autograd Functions as on the card) against the JAX package's
Pallas rasterizer in interpret mode and both oracles, the screen-offset
(densification) gradient among them; SSIM and the losses. Both sides get
the same numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch.core import transforms as ptr
from priordepth_gaussiansplatting_torch.ops import losses as plosses
from priordepth_gaussiansplatting_torch.ops import projection as pproj
from priordepth_gaussiansplatting_torch.ops import rasterize as prast
from priordepth_gaussiansplatting_torch.ops import reference as pref
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.core import transforms as jtr
from priordepth_gaussiansplatting_tpu.ops import losses as jlosses
from priordepth_gaussiansplatting_tpu.ops import projection as jproj
from priordepth_gaussiansplatting_tpu.ops import rasterize_pallas as rp
from priordepth_gaussiansplatting_tpu.ops import reference as jref
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)
W = H = 48
EYE = (0.0, 0.0, -2.5)


def assert_grads_close(got, want, atol_frac, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-8)
    np.testing.assert_allclose(got, want, atol=atol_frac * scale, rtol=rtol,
                               err_msg=what)


def grad_scene():
    """tests/test_pallas_vs_oracle.py::test_gradients_match_oracle's scene
    (48 Gaussians at 48x48) with every 7th Gaussian behind the camera and
    every 5th inactive."""
    g = PT.random_gaussians(2, 48, scale_range=(0.05, 0.15))
    g["means"][::7, 2] = -6.0
    valid = np.arange(48) % 5 != 0
    target = np.random.default_rng(3).random((3, H, W)).astype(np.float32)
    return g, valid, target


def jax_grads(g, valid, target, backend, exact=False):
    cam = JT.look_at_camera(EYE, width=W, height=H)
    bg = jnp.array([0.3, 0.3, 0.3])

    def loss(p):
        proj = jproj.project_gaussians(
            p["means"], jtr.scaling_rotation_to_cov3d(p["scales"], p["quats"]),
            p["opacities"], p["sh"], 3, cam.world_view, cam.full_proj,
            cam.cam_center, W, H, cam.tan_fovx, cam.tan_fovy,
            valid_mask=jnp.asarray(valid))
        proj = proj.__class__(
            mean2d=proj.mean2d + p["screen_offset"], conic=proj.conic,
            opacity=proj.opacity, rgb=proj.rgb, depth=proj.depth,
            invdepth=proj.invdepth, radius=proj.radius)
        if backend == "oracle":
            out = jref.rasterize_reference(proj, bg, W, H)
        else:
            out = rp.rasterize(proj, bg, W, H, interpret=True,
                               exact_grads=exact)
        return (jnp.mean((out["render"] - target) ** 2)
                + 0.1 * jnp.mean(jnp.abs(out["invdepth"])))

    grads = jax.grad(loss)({k: jnp.asarray(v) for k, v in g.items()}
                           | {"screen_offset": jnp.zeros((48, 2))})
    return {k: np.asarray(v) for k, v in grads.items()}


def port_grads(g, valid, target, backend):
    cam = PT.look_at_camera(EYE, width=W, height=H, device="cpu")
    bg = torch.tensor([0.3, 0.3, 0.3])
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in g.items()}
    p["screen_offset"] = torch.zeros(48, 2, requires_grad=True)
    proj = pproj.project_gaussians(
        p["means"], ptr.scaling_rotation_to_cov3d(p["scales"], p["quats"]),
        p["opacities"], p["sh"], 3, cam.world_view, cam.full_proj,
        cam.cam_center, W, H, cam.tan_fovx, cam.tan_fovy,
        valid_mask=torch.from_numpy(valid))
    proj = proj.replace(mean2d=proj.mean2d + p["screen_offset"])
    if backend == "oracle":
        out = pref.rasterize_reference(proj, bg, W, H)
    else:
        out = prast.rasterize(proj, bg, W, H)
        assert int(out["overflow"]) == 0
    loss = (torch.mean((out["render"] - torch.from_numpy(target)) ** 2)
            + 0.1 * torch.mean(torch.abs(out["invdepth"])))
    grads = torch.autograd.grad(loss, list(p.values()))
    return {k: v.numpy() for k, v in zip(p, grads)}


@pytest.fixture(scope="module")
def scene_grads():
    g, valid, target = grad_scene()
    return g, port_grads(g, valid, target, "kernels")


@pytest.mark.parametrize("reference", ["jax_exact", "jax_default",
                                       "jax_oracle", "port_oracle"])
def test_rasterizer_gradients(scene_grads, reference):
    g, got = scene_grads
    _, valid, target = grad_scene()
    if reference == "port_oracle":
        want = port_grads(g, valid, target, "oracle")
    elif reference == "jax_oracle":
        want = jax_grads(g, valid, target, "oracle")
    else:
        want = jax_grads(g, valid, target, "pallas",
                         exact=reference == "jax_exact")
    # The JAX default rounds each pair cotangent to bf16 before the sum
    # (tests/test_pallas_vs_oracle.py's looser bound); the rest are exact.
    atol, rtol = (2e-2, 3e-2) if reference == "jax_default" else (3e-4, 2e-3)
    for name in got:
        assert np.isfinite(got[name]).all(), name
        assert_grads_close(got[name], want[name], atol, rtol, name)
    # the culled and inactive rows get no gradient, and nothing else
    # vanishes
    dead = (np.arange(48) % 5 == 0) | (np.arange(48) % 7 == 0)
    for name in ("means", "screen_offset"):
        assert np.abs(got[name][dead]).max() == 0.0
        assert np.abs(got[name][~dead]).max() > 0.0


# --- losses ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 48, 64), (3, 17, 11)])
def test_ssim_value_and_gradient_match_jax(shape):
    rng = np.random.default_rng(shape[1])
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    want, want_g = jax.value_and_grad(jlosses.ssim)(jnp.asarray(a),
                                                    jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    got = plosses.ssim(ta, torch.from_numpy(b))
    got_g = torch.autograd.grad(got, ta)[0]
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    assert_grads_close(got_g.numpy(), np.asarray(want_g), 3e-4, 2e-3, "ssim")


def test_depth_and_photometric_losses_match_jax():
    rng = np.random.default_rng(8)
    pred, prior = rng.random((2, 40, 56)).astype(np.float32)
    mask = (rng.random((40, 56)) > 0.3).astype(np.float32)
    img = rng.random((2, 3, 40, 56)).astype(np.float32)
    pairs = [
        (plosses.depth_l1_loss(*map(torch.from_numpy, (pred, prior, mask))),
         jlosses.depth_l1_loss(*map(jnp.asarray, (pred, prior, mask)))),
        (plosses.photometric_loss(*map(torch.from_numpy, img)),
         jlosses.photometric_loss(*map(jnp.asarray, img))),
        (plosses.l2_loss(*map(torch.from_numpy, img)),
         jlosses.l2_loss(*map(jnp.asarray, img))),
    ]
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= 1e-6
