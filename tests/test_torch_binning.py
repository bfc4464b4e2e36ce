"""The port's binning (plain K1 and K5 through the same glue as the card)
against the JAX package's bin_sorted_pairs in interpret mode. Both sides
get the SAME projected Gaussians (JAX's, carried across), so projection
noise stays out: every field must be equal, the attribute table bit for
bit."""

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


def jax_projected(seed, n, wh, scale_range=(0.02, 0.1), aa=True):
    g = PT.random_gaussians(seed, n, scale_range=scale_range)
    cam = JT.look_at_camera((0, 0, -2.5), width=wh, height=wh)
    return jproj.project_gaussians(
        jnp.asarray(g["means"]),
        jtr.scaling_rotation_to_cov3d(jnp.asarray(g["scales"]),
                                      jnp.asarray(g["quats"])),
        jnp.asarray(g["opacities"]), jnp.asarray(g["sh"]), 3,
        cam.world_view, cam.full_proj, cam.cam_center, wh, wh,
        cam.tan_fovx, cam.tan_fovy, antialiasing=aa)


def to_port(proj):
    return interop.projected_from_numpy(
        *(np.asarray(getattr(proj, f)) for f in
          ("mean2d", "conic", "opacity", "rgb", "depth", "invdepth",
           "radius")), device="cpu")


def unpack_jax_table(attrs16, ncols):
    """JAX's (16, L) bit-packed pair table -> (10, ncols) in ATTR_* order."""
    a = jnp.asarray(attrs16)[:, :ncols]
    hi, lo = jbin.unpack_bf16_rows(a[2:6])
    hi, lo = np.asarray(hi), np.asarray(lo)
    return np.stack([np.asarray(a[0]), np.asarray(a[1]),
                     hi[0], lo[0], hi[1], lo[1], hi[2], lo[2], hi[3], lo[3]])


def bin_both(proj_j, wh, p_cap, v_cap):
    want_t, want = jbin.bin_sorted_pairs(proj_j, wh, wh, p_cap, v_cap,
                                         interpret=True)
    got_t, got = pbin.bin_sorted_pairs(to_port(proj_j), wh, wh, p_cap, v_cap)
    return got_t, got, want_t, want


CASES = {
    # the scenes of tests/test_pallas_vs_oracle.py::test_forward_matches_oracle
    "64px": dict(seed=64, n=64, wh=64, p_cap=None, v_cap=None),
    "128px": dict(seed=256, n=256, wh=128, p_cap=None, v_cap=None),
    # pair capacity below the rect pair total: the last Gaussians' pairs
    # are truncated and counted in overflow_rect
    "rect_overflow": dict(seed=7, n=256, wh=128, p_cap=1024, v_cap=None,
                          scale_range=(0.05, 0.2)),
    # valid capacity below the kept pairs: tile ranges clamp
    "valid_overflow": dict(seed=8, n=256, wh=128, p_cap=8192, v_cap=1024,
                           scale_range=(0.05, 0.2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bin_sorted_pairs_matches_jax(case):
    c = dict(CASES[case])
    proj_j = jax_projected(c["seed"], c["n"], c["wh"],
                           c.get("scale_range", (0.02, 0.1)))
    p_cap = c["p_cap"] or rp.default_pair_capacity(c["n"])
    v_cap = c["v_cap"] or p_cap
    got_t, got, want_t, want = bin_both(proj_j, c["wh"], p_cap, v_cap)

    for key in ("tile_start", "tile_end"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("num_valid", "num_rect", "overflow_rect", "overflow_valid"):
        assert int(got[key]) == int(want[key]), key
    if case == "rect_overflow":
        assert int(got["overflow_rect"]) > 0
    if case == "valid_overflow":
        assert int(got["overflow_valid"]) > 0
    m = min(int(want["num_valid"]), v_cap)
    assert m > 0
    np.testing.assert_array_equal(got["gid_sorted"][:m].numpy(),
                                  np.asarray(want["gid_sorted"])[:m])
    assert got_t.shape == (pbin.ATTR_ROWS, v_cap + pbin.COMPOSITE_PAD)
    np.testing.assert_array_equal(
        got_t[:, :m].numpy().view(np.uint32),
        unpack_jax_table(want_t, m).view(np.uint32))
    assert not got_t[:, v_cap:].any()


def test_expand_pairs_plain_counts_and_order():
    """K1's plain version on its own: every kept slot's tile is counted
    once, padding slots carry num_tiles, and the tile-sorted pairs are in
    depth order within each tile."""
    proj = to_port(jax_projected(3, 128, 64))
    W = H = 64
    grid_x, grid_y = pbin.grid_shape(W, H)
    rects = pbin.depth_sorted_rects(proj, W, H)
    total = rects["total"]
    p_cap = int(total) + 100
    tile, gid, attrs, hist = pbin.expand_pairs(
        **rects, p_cap=p_cap, grid_x=grid_x, num_tiles=grid_x * grid_y)
    num_tiles = grid_x * grid_y
    assert (tile[int(total):] == num_tiles).all()
    assert (gid[int(total):] == -1).all()
    kept = tile < num_tiles
    assert int(hist.sum()) == int(kept.sum()) > 0
    np.testing.assert_array_equal(
        hist.numpy(), np.bincount(tile[kept].numpy(), minlength=num_tiles))
    perm = torch.sort(tile, stable=True).indices
    t_s, g_s = tile[perm], gid[perm]
    d = proj.depth[g_s[:int(kept.sum())].long()]
    same_tile = t_s[1:int(kept.sum())] == t_s[:int(kept.sum()) - 1]
    assert (d[1:][same_tile] >= d[:-1][same_tile]).all()


def _owner_cases():
    """Depth-ordered rect pair counts (live Gaussians first, zero-count
    rects at the tail) for K1's owner window, with its pair capacity."""
    rng = np.random.default_rng(9)
    return {
        # one owner spanning 26+ blocks, blocks spanning 200+ owners and
        # zero-count rects at the tail
        "long_and_dense": (np.concatenate(
            [rng.integers(1, 4, 300), [26 * 256 + 77],
             np.ones(900, np.int64), rng.integers(1, 40, 200),
             np.zeros(50, np.int64)]), 9000),
        # the capacity cuts the slots inside a rect (a ragged last block)
        "ragged_capacity": (np.concatenate(
            [rng.integers(1, 9, 500), np.zeros(7, np.int64)]), 1234),
    }


@pytest.mark.parametrize("case", sorted(_owner_cases()))
def test_owner_window_plain_matches_searchsorted(case):
    """K1's block partition (the owner of each block's first slot from the
    warp's search, then the block's window of owners) gives every live
    slot the owner ``searchsorted`` gives it, with at most one owner per
    slot and no block spilling on depth-sorted offsets."""
    counts, p_cap = _owner_cases()[case]
    offsets = torch.from_numpy(np.cumsum(counts) - counts).to(torch.int32)
    total = torch.tensor([int(counts.sum())], dtype=torch.int32)
    j0, count, spill = pbin.owner_window_plain(offsets, total, p_cap)
    tot = min(int(total), p_cap)
    assert j0.shape[0] == -(-tot // pbin.EXPAND_BLOCK)
    assert not spill.any()
    assert int(count.min()) >= 1 and int(count.max()) <= pbin.EXPAND_BLOCK
    pos = torch.arange(tot, dtype=torch.int32)
    want = torch.searchsorted(offsets, pos, right=True) - 1
    block = pos.long() // pbin.EXPAND_BLOCK
    got = torch.empty_like(want)
    for b in range(j0.shape[0]):
        window = offsets[j0[b]:j0[b] + count[b]]
        sel = block == b
        got[sel] = j0[b] + torch.searchsorted(window, pos[sel],
                                              right=True) - 1
    assert torch.equal(got, want)
    owners_per_block = [int(want[block == b].unique().numel())
                        for b in range(j0.shape[0])]
    assert owners_per_block == count.tolist()
    if case == "long_and_dense":
        assert max(owners_per_block) >= 200
        assert int((want == 300).sum()) >= 26 * pbin.EXPAND_BLOCK


def test_owner_window_plain_spills_past_one_owner_per_thread():
    """Offsets that do not ascend strictly (zero-count rects among the
    live ones, which the depth sort does not produce) can put more owners
    before a block's last slot than it has slots: the window says so,
    and the kernel then searches each slot's owner in device memory."""
    counts = np.concatenate([[5], np.zeros(300, np.int64), [600]])
    offsets = torch.from_numpy(np.cumsum(counts) - counts).to(torch.int32)
    total = torch.tensor([605], dtype=torch.int32)
    j0, count, spill = pbin.owner_window_plain(offsets, total, 1024)
    assert spill.tolist() == [True, False, False]
    assert count[0] == pbin.EXPAND_BLOCK and j0.tolist()[1:] == [301, 301]


@pytest.mark.parametrize("seed", range(4))
def test_warp_lower_bound_plain_matches_searchsorted(seed):
    """The 32-way search K1 and K4 run in one warp finds the lower bound
    over any subrange, for values below, inside and above the keys, and on
    runs of equal keys."""
    rng = np.random.default_rng(seed)
    v = int(rng.integers(1, 5000)) if seed else 2_600_000
    a = torch.from_numpy(np.sort(rng.integers(0, v // 3 + 2, v))).to(
        torch.int32)
    for _ in range(20):
        lo = int(rng.integers(0, v))
        hi = int(rng.integers(lo, v + 1))
        x = int(rng.integers(-1, v // 3 + 4))
        want = lo + int(torch.searchsorted(a[lo:hi], x))
        assert pbin.warp_lower_bound_plain(a, lo, hi, x) == want
