"""The port's core math and projection against the JAX package, on the same
numpy inputs: SH, transforms, cameras, round_bf16, project_gaussians, and
the projection of a whole store (``project_state_plain``, K8's plain
version) on the cull's edge rows."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.core import sh as psh
from priordepth_gaussiansplatting_torch.core import transforms as ptr
from priordepth_gaussiansplatting_torch.ops import projection as pproj
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.core import cameras as jcam
from priordepth_gaussiansplatting_tpu.core import sh as jsh
from priordepth_gaussiansplatting_tpu.core import transforms as jtr
from priordepth_gaussiansplatting_tpu.models import gaussians as jgm
from priordepth_gaussiansplatting_tpu.ops import projection as jproj
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def assert_bf16_close(got, want, what, flips=None):
    """Bit-equal on >= 99.9% of elements (or on all but `flips`), else
    within one bf16 ulp: a one-ulp f32 difference before rounding can flip
    an RTNE tie."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    same = _bits(got) == _bits(want)
    if flips is None:
        assert same.mean() >= 0.999, (what, same.mean())
    else:
        assert (~same).sum() <= flips, (what, (~same).sum())
    mag = np.maximum(np.abs(got), np.abs(want))[~same]
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(got - want)[~same] <= ulp).all(), what


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    dirs = rng.standard_normal((500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    k = psh.num_sh_bases(degree)
    coeffs = rng.standard_normal((500, 3 * k)).astype(np.float32)
    got = psh.sh_to_color(degree, torch.from_numpy(coeffs),
                          torch.from_numpy(dirs)).numpy()
    want = np.asarray(jsh.sh_to_color(degree, jnp.asarray(coeffs),
                                      jnp.asarray(dirs)))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)
    basis = psh.sh_basis(torch.from_numpy(dirs), degree).numpy()
    np.testing.assert_allclose(
        basis, np.asarray(jsh.sh_basis(jnp.asarray(dirs), degree)),
        atol=1e-6)


def test_cov3d_matches_jax():
    g = PT.random_gaussians(3, 300)
    got = ptr.scaling_rotation_to_cov3d(torch.from_numpy(g["scales"]),
                                        torch.from_numpy(g["quats"])).numpy()
    want = np.asarray(jtr.scaling_rotation_to_cov3d(
        jnp.asarray(g["scales"]), jnp.asarray(g["quats"])))
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=1e-5)
    x = np.linspace(0.05, 0.95, 19, dtype=np.float32)
    np.testing.assert_allclose(
        ptr.inverse_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jtr.inverse_sigmoid(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("eye,size", [((0, 0, -2.5), (64, 64)),
                                      ((0.7, -0.4, -2.2), (160, 96))])
def test_camera_matrices_match_jax(eye, size):
    w, h = size
    want = JT.look_at_camera(eye, width=w, height=h, fovx=math.radians(50))
    got = PT.look_at_camera(eye, width=w, height=h, fovx=math.radians(50),
                            device="cpu")
    for field in ("world_view", "full_proj", "cam_center"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert (got.width, got.height) == (want.width, want.height)
    assert got.tan_fovx == want.tan_fovx and got.tan_fovy == want.tan_fovy


def _round_inputs():
    rng = np.random.default_rng(11)
    rand = (rng.standard_normal(4000)
            * np.exp2(rng.integers(-30, 30, 4000))).astype(np.float32)
    # exact ties (low half 0x8000) with both parities of the kept bit
    ties = ((rng.integers(0, 1 << 15, 200, dtype=np.uint32) << 16)
            | np.uint32(0x8000)).view(np.float32)
    sub = (rng.integers(1, 1 << 23, 200, dtype=np.uint32)).view(np.float32)
    special = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                        np.finfo(np.float32).max], np.float32)
    payload_nan = np.array([0x7FC01234, 0xFF80FFFF], np.uint32).view(np.float32)
    return np.concatenate([rand, ties, sub, -sub, special, payload_nan])


def test_round_bf16_bit_equal_to_jax():
    x = _round_inputs()
    got = pproj.round_bf16(torch.from_numpy(x)).numpy()
    want = np.asarray(jproj.round_bf16(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_round_bf16_gradient_is_identity():
    x = torch.from_numpy(_round_inputs()[:4000].copy()).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(4000)
                         .astype(np.float32))
    pproj.round_bf16(x).backward(g)
    np.testing.assert_array_equal(x.grad.numpy(), g.numpy())


def _project_both(aa: bool, masked: bool, n=256, w=128, h=96):
    g = PT.random_gaussians(21, n, scale_range=(0.01, 0.12))
    # a few Gaussians behind the near plane
    g["means"][:8, 2] = -2.45
    cam_j = JT.look_at_camera((0.2, -0.1, -2.5), width=w, height=h)
    mask = np.random.default_rng(5).random(n) > 0.1 if masked else None
    want = jproj.project_gaussians(
        jnp.asarray(g["means"]),
        jtr.scaling_rotation_to_cov3d(jnp.asarray(g["scales"]),
                                      jnp.asarray(g["quats"])),
        jnp.asarray(g["opacities"]), jnp.asarray(g["sh"]), 3,
        cam_j.world_view, cam_j.full_proj, cam_j.cam_center, w, h,
        cam_j.tan_fovx, cam_j.tan_fovy, antialiasing=aa,
        valid_mask=None if mask is None else jnp.asarray(mask))
    cam = interop.camera_from_numpy(
        np.asarray(cam_j.world_view), np.asarray(cam_j.full_proj),
        np.asarray(cam_j.cam_center), w, h, cam_j.fovx, cam_j.fovy,
        device="cpu")
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    got = pproj.project_gaussians(
        t["means"], ptr.scaling_rotation_to_cov3d(t["scales"], t["quats"]),
        t["opacities"], t["sh"], 3, cam.world_view, cam.full_proj,
        cam.cam_center, w, h, cam.tan_fovx, cam.tan_fovy, antialiasing=aa,
        valid_mask=None if mask is None else torch.from_numpy(mask))
    return got, want


@pytest.mark.parametrize("aa,masked", [(False, False), (True, False),
                                       (True, True)])
def test_project_gaussians_matches_jax(aa, masked):
    got, want = _project_both(aa, masked)
    # Culled rows (radius 0) are never read; behind the near plane their
    # 1/w amplifies matmul rounding to ~1e-2 px.
    live = np.asarray(want.radius) > 0
    assert live.sum() > 200
    np.testing.assert_allclose(got.mean2d.numpy()[live],
                               np.asarray(want.mean2d)[live], atol=1e-4)
    d_got, d_want = got.depth.numpy(), np.asarray(want.depth)
    np.testing.assert_array_equal(np.isinf(d_got), np.isinf(d_want))
    fin = np.isfinite(d_want)
    assert (~fin).sum() >= 8
    np.testing.assert_allclose(d_got[fin], d_want[fin], atol=1e-4)
    for field in ("conic", "opacity", "rgb", "invdepth"):
        assert_bf16_close(getattr(got, field).numpy(),
                          np.asarray(getattr(want, field)), field)
    r_got, r_want = got.radius.numpy(), np.asarray(want.radius)
    assert r_got.dtype == np.int32
    assert (r_got == r_want).mean() >= 0.999
    assert np.abs(r_got - r_want).max() <= 1


def _jax_store(st):
    """The JAX package's store holding the port's store `st`'s numbers."""
    n = st.capacity
    return jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(v.numpy())
                                     for k, v in vars(st.params).items()}),
        active=jnp.asarray(st.active.numpy()), max_radii2d=jnp.zeros(n),
        xyz_gradient_accum=jnp.zeros(n), denom=jnp.zeros(n),
        active_sh_degree=jnp.asarray(st.active_sh_degree, jnp.int32),
        max_sh_degree=st.max_sh_degree)


# (active SH degree, antialiasing, scaling modifier, override colour)
STORE_CASES = ([(d, aa, m, False) for d in range(4) for aa in (False, True)
                for m in (1.0, 0.7)]
               + [(3, aa, 1.0, True) for aa in (False, True)])


@pytest.mark.parametrize("degree,aa,modifier,override", STORE_CASES)
def test_store_projection_matches_jax_on_the_edge_rows(degree, aa, modifier,
                                                       override):
    """``project_state_plain``, the render's projection on the CPU and with
    gradients, against the JAX package's ``project_gaussians`` over its
    store's activations, on ``utils/testing.py::edge_store``: z exactly
    0.2, the next f32 above it, z = 0, behind the camera, det == 0 and
    inactive rows are culled or kept alike, and the rest agree as in
    test_project_gaussians_matches_jax."""
    st = PT.edge_store(degree, degree, device="cpu")
    cam = PT.axis_camera(device="cpu")
    jst = _jax_store(st)
    jc = jcam.make_camera(np.eye(3), np.zeros(3), cam.fovx, cam.fovy,
                          cam.width, cam.height)
    for field in ("world_view", "full_proj", "cam_center"):
        np.testing.assert_array_equal(getattr(cam, field).numpy(),
                                      np.asarray(getattr(jc, field)))
    colour = (np.random.default_rng(3).random((st.capacity, 3))
              .astype(np.float32) if override else None)
    got = pproj.project_state_plain(
        st, cam, scaling_modifier=modifier, antialiasing=aa,
        override_color=None if colour is None else torch.from_numpy(colour))
    want = jproj.project_gaussians(
        jst.params.xyz, jst.get_covariance(modifier), jst.get_opacity(),
        jst.get_features(), jst.max_sh_degree, jc.world_view, jc.full_proj,
        jc.cam_center, cam.width, cam.height, jc.tan_fovx, jc.tan_fovy,
        antialiasing=aa, valid_mask=jst.active,
        colors_precomp=None if colour is None else jnp.asarray(colour))

    r_got, r_want = got.radius.numpy(), np.asarray(want.radius)
    np.testing.assert_array_equal(r_got, r_want)
    assert r_got[PT.PAST_NEAR] > 0
    for row in (PT.AT_NEAR, PT.AT_ZERO, PT.BEHIND, PT.FLAT, PT.INACTIVE):
        assert r_got[row] == 0, row
    assert not r_got[~st.active.numpy()].any()
    live = r_want > 0
    assert live.sum() > 150
    # Culled rows: zero opacity, infinite depth, zero inverse depth in
    # both; their conic and mean are never read.
    for field, value in (("opacity", 0.0), ("depth", np.inf),
                         ("invdepth", 0.0)):
        np.testing.assert_array_equal(getattr(got, field).numpy()[~live],
                                      value)
        np.testing.assert_array_equal(np.asarray(getattr(want, field))[~live],
                                      value)
    np.testing.assert_allclose(got.mean2d.numpy()[live],
                               np.asarray(want.mean2d)[live], atol=1e-4)
    np.testing.assert_allclose(got.depth.numpy()[live],
                               np.asarray(want.depth)[live], atol=1e-4)
    # The two packages form the 3D covariance in other f32 orders (most
    # rows differ in a last bit), so a rounded output whose f32 value lies
    # within an ulp of a bf16 rounding boundary may land one step apart:
    # at most 2 of a field's ~200-650 live elements.
    for field in ("conic", "opacity", "rgb", "invdepth"):
        assert_bf16_close(getattr(got, field).numpy()[live],
                          np.asarray(getattr(want, field))[live], field,
                          flips=2)
    if override:
        np.testing.assert_array_equal(
            got.rgb.numpy(), pproj.round_bf16(torch.from_numpy(colour)))


@pytest.mark.parametrize("tight", [False, True])
def test_tile_rects_match_jax(tight):
    got, want = _project_both(True, True)
    w, h = 128, 96
    if tight:
        a = pproj.tile_rect_tight(got, w, h)
        b = jproj.tile_rect_tight(want, w, h)
    else:
        a = pproj.tile_rect(got.mean2d, got.radius, w, h)
        b = jproj.tile_rect(want.mean2d, want.radius, w, h)
    for x, y in zip(a, b):
        assert (x.numpy() == np.asarray(y)).mean() >= 0.99
