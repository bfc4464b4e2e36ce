"""The port's tile compositor (plain K2 through the same glue as the card)
against the JAX package's Pallas rasterizer in interpret mode, and against
both oracles, on the same projected Gaussians."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.ops import rasterize as prast
from priordepth_gaussiansplatting_torch.ops import reference as pref
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.core import transforms as jtr
from priordepth_gaussiansplatting_tpu.ops import projection as jproj
from priordepth_gaussiansplatting_tpu.ops import rasterize_pallas as rp
from priordepth_gaussiansplatting_tpu.ops import reference as jref
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)


def jax_projected(g, wh, eye=(0, 0, -2.5)):
    cam = JT.look_at_camera(eye, width=wh, height=wh)
    return jproj.project_gaussians(
        jnp.asarray(g["means"]),
        jtr.scaling_rotation_to_cov3d(jnp.asarray(g["scales"]),
                                      jnp.asarray(g["quats"])),
        jnp.asarray(g["opacities"]), jnp.asarray(g["sh"]), 3,
        cam.world_view, cam.full_proj, cam.cam_center, wh, wh,
        cam.tan_fovx, cam.tan_fovy)


def to_port(proj):
    return interop.projected_from_numpy(
        *(np.asarray(getattr(proj, f)) for f in
          ("mean2d", "conic", "opacity", "rgb", "depth", "invdepth",
           "radius")), device="cpu")


@pytest.mark.parametrize("n,wh", [(64, 64), (256, 128)])
def test_rasterize_matches_jax_and_oracles(n, wh):
    proj_j = jax_projected(PT.random_gaussians(n, n), wh)
    proj = to_port(proj_j)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    got = prast.rasterize(proj, torch.from_numpy(bg), wh, wh)
    want = rp.rasterize(proj_j, jnp.asarray(bg), wh, wh, interpret=True)
    oracle = pref.rasterize_reference(proj, torch.from_numpy(bg), wh, wh)
    oracle_j = jref.rasterize_reference(proj_j, jnp.asarray(bg), wh, wh)
    assert int(got["overflow"]) == 0
    for key in ("num_pairs", "num_rect_pairs", "overflow"):
        assert int(got[key]) == int(want[key]), key
    for key in ("render", "invdepth", "final_T"):
        g = got[key].numpy()
        assert g.shape == np.asarray(want[key]).shape
        for ref in (want[key], oracle[key].numpy(), oracle_j[key]):
            np.testing.assert_allclose(g, np.asarray(ref), atol=2e-5,
                                       err_msg=key)


def test_rasterize_dense_overlap():
    """Near-opaque chains hit the T < 1e-4 stop; differently rounded
    products may flip the cut-off pair on a few pixels (the rule of
    tests/test_pallas_vs_oracle.py)."""
    g = PT.random_gaussians(5, 128, extent=0.3, scale_range=(0.1, 0.3),
                            opacity_range=(0.9, 0.99))
    proj_j = jax_projected(g, 48, eye=(0, 0, -2.0))
    proj = to_port(proj_j)
    got = prast.rasterize(proj, torch.zeros(3), 48, 48)["render"].numpy()
    for ref in (rp.rasterize(proj_j, jnp.zeros(3), 48, 48,
                             interpret=True)["render"],
                jref.rasterize_reference(proj_j, jnp.zeros(3), 48,
                                         48)["render"]):
        diff = np.abs(got - np.asarray(ref))
        assert (diff <= 3e-5).mean() > 0.99
        assert diff.max() < 5e-3


def test_overflow_is_reported_like_jax():
    g = PT.random_gaussians(9, 256, scale_range=(0.05, 0.2))
    proj_j = jax_projected(g, 64)
    got = prast.rasterize(to_port(proj_j), torch.zeros(3), 64, 64,
                          pair_capacity=1024, valid_capacity=1024)
    want = rp.rasterize(proj_j, jnp.zeros(3), 64, 64, pair_capacity=1024,
                        valid_capacity=1024, interpret=True)
    assert int(got["overflow"]) == int(want["overflow"]) > 0
    np.testing.assert_allclose(got["render"].numpy(),
                               np.asarray(want["render"]), atol=2e-5)


def test_composite_tiles_subset_matches_full():
    """The `tiles=` selection composites exactly the listed tiles."""
    proj = to_port(jax_projected(PT.random_gaussians(2, 96), 64))
    from priordepth_gaussiansplatting_torch.ops import binning as pbin
    table, aux = pbin.bin_sorted_pairs(proj, 64, 64, 4096)
    full = prast.composite_fwd(table, aux["tile_start"], aux["tile_end"], 4)
    tiles = torch.tensor([13, 2, 7], dtype=torch.int32)
    part = prast.composite_fwd(table, aux["tile_start"], aux["tile_end"], 4,
                               tiles=tiles)
    for f, p in zip(full, part):
        idx = tiles.long()
        np.testing.assert_array_equal((f[:, idx] if f.dim() == 3
                                       else f[idx]).numpy(), p.numpy())
    n_eval = full[3]
    counts = (aux["tile_end"] - aux["tile_start"]).long()
    assert (n_eval <= counts[:, None]).all() and int(n_eval.sum()) > 0


def test_capacity_ladder_matches_jax():
    for pairs in (1, 4096, 5000, 70_000, 1_234_567, 9_000_000):
        assert prast.round_capacity(pairs) == rp.round_capacity(pairs)
    for n in (10, 1000, 123_456):
        assert prast.default_pair_capacity(n) == rp.default_pair_capacity(n)
