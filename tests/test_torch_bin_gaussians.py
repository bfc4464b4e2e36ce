"""The port's first-round binning (``bin_gaussians``: depth order, plain K7,
tile ranges, the tile sort) against the JAX package's ``bin_gaussians``,
whose Pallas kernel runs in interpret mode on the CPU. Both sides get the
same projected Gaussians (JAX's, carried across). ``depth_order``,
``tile_start``, ``tile_end``, ``num_pairs`` and ``overflow`` must be
equal, and ``tile_ids``/``gauss_ids`` over the first ``num_pairs`` slots
(JAX leaves the Gaussian id of a padding slot unspecified). A rect 256
tiles wide or more, which the JAX package packs wrongly, is held against a
direct enumeration instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.ops import binning as pbin
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.core import transforms as jtr
from priordepth_gaussiansplatting_tpu.ops import binning as jbin
from priordepth_gaussiansplatting_tpu.ops import projection as jproj
from priordepth_gaussiansplatting_tpu.ops import rasterize_pallas as rp
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)


def jax_projected(seed, n, w, h, scale_range=(0.02, 0.1), behind=0,
                  aside=0):
    """Every `behind`-th Gaussian behind the camera (culled, depth inf) and
    every `aside`-th far off to the side (in front, but an empty rect)."""
    g = PT.random_gaussians(seed, n, scale_range=scale_range)
    if behind:
        g["means"][::behind, 2] = -6.0
    if aside:
        g["means"][1::aside, 0] = 40.0
    cam = JT.look_at_camera((0, 0, -2.5), width=w, height=h)
    return jproj.project_gaussians(
        jnp.asarray(g["means"]),
        jtr.scaling_rotation_to_cov3d(jnp.asarray(g["scales"]),
                                      jnp.asarray(g["quats"])),
        jnp.asarray(g["opacities"]), jnp.asarray(g["sh"]), 3,
        cam.world_view, cam.full_proj, cam.cam_center, w, h,
        cam.tan_fovx, cam.tan_fovy, antialiasing=True)


def to_port(proj):
    return interop.projected_from_numpy(
        *(np.asarray(getattr(proj, f)) for f in
          ("mean2d", "conic", "opacity", "rgb", "depth", "invdepth",
           "radius")), device="cpu")


CASES = {
    "64px": dict(seed=64, n=64, w=64, h=64),
    "128px": dict(seed=256, n=256, w=128, h=96, behind=11, aside=7),
    # the capacity below the rect pair total: the last Gaussians' pairs
    # are dropped and counted in overflow
    "overflow": dict(seed=7, n=256, w=128, h=128, p_cap=1024,
                     scale_range=(0.05, 0.2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bin_gaussians_matches_jax(case):
    c = dict(CASES[case])
    proj_j = jax_projected(c["seed"], c["n"], c["w"], c["h"],
                           c.get("scale_range", (0.02, 0.1)),
                           c.get("behind", 0), c.get("aside", 0))
    p_cap = c.get("p_cap") or rp.default_pair_capacity(c["n"])
    want = jbin.bin_gaussians(proj_j, c["w"], c["h"], p_cap, interpret=True)
    proj = to_port(proj_j)
    got = pbin.bin_gaussians(proj, c["w"], c["h"], p_cap)

    for key in ("depth_order", "tile_start", "tile_end"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)),
                                      err_msg=key)
    for key in ("num_pairs", "overflow"):
        assert int(getattr(got, key)) == int(getattr(want, key)), key
    m = int(want.num_pairs)
    assert m > 0
    for key in ("tile_ids", "gauss_ids"):
        np.testing.assert_array_equal(getattr(got, key)[:m].numpy(),
                                      np.asarray(getattr(want, key))[:m],
                                      err_msg=key)
    grid_x, grid_y = pbin.grid_shape(c["w"], c["h"])
    assert (got.tile_ids[m:] == grid_x * grid_y).all()
    assert (got.gauss_ids[m:] == -1).all()
    if case == "overflow":
        assert int(got.overflow) > 0 and m == p_cap
    if c.get("aside"):
        # zero-count rects in front of the camera, among the live ones
        _, _, counts = pbin._rect_geometry(proj, c["w"], c["h"], tight=False)
        assert bool(((counts == 0) & torch.isfinite(proj.depth)).any())


WIDE = (4096, 80)
NT = 256 * 5


def wide_scene():
    """A 4096x80 camera (256x5 tiles): one Gaussian whose rect spans all
    256 tile columns, small ones in front and behind it, one with radius 0
    and one off to the side (both zero-count)."""
    mean2d = [[2048.0, 40.0], [100.0, 10.0], [4000.0, 60.0], [2047.0, 45.0],
              [700.0, 20.0], [9000.0, 20.0]]
    radius = [2100, 20, 40, 8, 0, 30]
    depth = [2.0, 1.0, 3.0, 2.0, 1.5, 0.5]
    n = len(radius)
    return interop.projected_from_numpy(
        np.array(mean2d, np.float32), np.tile([1.0, 0.0, 1.0], (n, 1)),
        np.full(n, 0.5), np.full((n, 3), 0.5), np.array(depth, np.float32),
        1.0 / np.array(depth, np.float32), np.array(radius, np.int32),
        device="cpu")


def test_wide_rect_matches_direct_enumeration():
    """Rects 256 tiles wide or more expand to their true tiles (the JAX
    package caps the packed width at 255 and is not the reference here)."""
    w, h = WIDE
    proj = wide_scene()
    _, nx, counts = pbin._rect_geometry(proj, w, h, tight=False)
    assert int(nx.max()) == 256 and int((counts == 0).sum()) == 2
    slots = PT.enumerate_slots(proj, w, h)
    want = slots[np.argsort(slots[:, 0], kind="stable")]
    total = want.shape[0]
    p_cap = 1024 * (total // 1024 + 1)
    got = pbin.bin_gaussians(proj, w, h, p_cap)
    assert int(got.num_pairs) == total and int(got.overflow) == 0
    np.testing.assert_array_equal(got.tile_ids[:total].numpy(), want[:, 0])
    np.testing.assert_array_equal(got.gauss_ids[:total].numpy(), want[:, 1])
    counts_t = np.bincount(want[:, 0], minlength=NT)
    np.testing.assert_array_equal((got.tile_end - got.tile_start).numpy(),
                                  counts_t)
    np.testing.assert_array_equal(got.depth_order.numpy(),
                                  np.argsort(proj.depth.numpy(),
                                             kind="stable"))

    # K7's plain version slot by slot, before the tile sort.
    x = pbin.tile_inputs(proj, w, h, p_cap)
    tile, gid, hist = pbin.expand_tiles_plain(
        x["offsets"], x["base"], x["nx"], x["gid"], x["total"], p_cap, 256,
        NT)
    np.testing.assert_array_equal(tile[:total].numpy(), slots[:, 0])
    np.testing.assert_array_equal(gid[:total].numpy(), slots[:, 1])
    np.testing.assert_array_equal(hist.numpy(), counts_t)
    assert (tile[total:] == NT).all() and (gid[total:] == -1).all()


def test_expand_tiles_truncates_at_the_capacity():
    """A capacity that cuts the wide rect: the first p_cap slots of the
    enumeration in depth order, the histogram of those alone."""
    w, h = WIDE
    proj = wide_scene()
    x = pbin.tile_inputs(proj, w, h, 1024)
    assert int(x["total_all"]) > 1024 and int(x["total"]) == 1024
    tile, gid, hist = pbin.expand_tiles_plain(
        x["offsets"], x["base"], x["nx"], x["gid"], x["total"], 1024, 256,
        NT)
    slots = PT.enumerate_slots(proj, w, h)[:1024]
    np.testing.assert_array_equal(tile.numpy(), slots[:, 0])
    np.testing.assert_array_equal(gid.numpy(), slots[:, 1])
    np.testing.assert_array_equal(hist.numpy(),
                                  np.bincount(slots[:, 0], minlength=NT))
    binned = pbin.bin_gaussians(proj, w, h, 1024)
    assert int(binned.overflow) == int(x["total_all"]) - 1024


def test_bin_gaussians_rejects_an_unaligned_capacity():
    with pytest.raises(ValueError, match="multiple"):
        pbin.bin_gaussians(wide_scene(), *WIDE, 1000)
