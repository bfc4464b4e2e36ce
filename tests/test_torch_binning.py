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


TILE_CASES = ("zero_runs", "clamped_tail", "ragged_capacity", "wide_rect",
              "dense", "empty", "spill")


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


def check_window(offsets, total, p_cap, slots=pbin.EXPAND_BLOCK, chunks=1,
                 grid=None):
    """``owner_window_plain``'s partition against ``searchsorted``, range by
    range (``window_steps``): j0 from the warp's search, the entries the
    block stages (j0 on, `chunks` chunks of EXPAND_BLOCK), its owners among
    them (the ends of runs of equal offsets at or below its last slot),
    each slot's owner found among those, and the spill flag (the owners
    reach past the staged entries). Returns j0, the counts and the spill
    flags."""
    j0, count, spill = pbin.owner_window_plain(offsets, total, p_cap, slots,
                                               chunks, grid)
    starts, lasts = pbin.window_steps(total, p_cap, slots, grid)
    off = offsets.long()
    n = off.shape[0]
    tot = min(int(total), p_cap)
    covered = torch.cat([torch.arange(int(a), int(z) + 1)
                         for a, z in zip(starts, lasts)] or
                        [torch.zeros(0, dtype=torch.int64)])
    assert torch.equal(covered, torch.arange(tot))  # each slot once, in order
    assert j0.shape[0] == count.shape[0] == starts.shape[0]
    span = chunks * pbin.EXPAND_BLOCK
    nxt = torch.cat([off[1:], off.new_tensor([2 ** 62])])
    want = torch.searchsorted(off, torch.arange(tot), right=True) - 1
    for b, (p0, last) in enumerate(zip(starts.tolist(), lasts.tolist())):
        assert last - p0 < slots
        j = int(j0[b])
        assert j == pbin.warp_lower_bound_plain(off, 0, n, p0 + 1) - 1
        beyond = j + span
        assert bool(spill[b]) == (beyond < n and int(off[beyond]) <= last)
        if spill[b]:
            continue
        idx = torch.arange(j, min(beyond, n))
        owners = idx[(off[idx] <= last) & (nxt[idx] > off[idx])]
        assert int(count[b]) == owners.numel() <= slots
        sl = torch.arange(p0, last + 1)
        got = owners[torch.searchsorted(off[owners], sl, right=True) - 1]
        assert torch.equal(got, want[p0:last + 1])
    return j0, count, spill


@pytest.mark.parametrize("case", sorted(_owner_cases()))
def test_owner_window_plain_matches_searchsorted(case):
    """K1's block partition (the owner of each block's first slot from the
    warp's search, then the block's window of owners) gives every live
    slot the owner ``searchsorted`` gives it, with at most one owner per
    slot and no block spilling on depth-sorted offsets."""
    counts, p_cap = _owner_cases()[case]
    offsets = torch.from_numpy(np.cumsum(counts) - counts).to(torch.int32)
    total = torch.tensor([int(counts.sum())], dtype=torch.int32)
    _, count, spill = check_window(offsets, total, p_cap)
    assert not spill.any()
    assert int(count.min()) >= 1
    if case == "long_and_dense":
        assert int(count.max()) >= 200
        want = torch.searchsorted(offsets, torch.arange(int(total)),
                                  right=True) - 1
        assert int((want == 300).sum()) >= 26 * pbin.EXPAND_BLOCK


def test_owner_window_plain_spills_past_one_owner_per_thread():
    """Offsets that do not ascend strictly (zero-count rects among the
    live ones, which K1's depth sort does not produce) can put more
    entries before a block's last slot than K1's one chunk holds: the
    window says so, and the kernel then searches each slot's owner in
    device memory."""
    counts = np.concatenate([[5], np.zeros(300, np.int64), [600]])
    offsets = torch.from_numpy(np.cumsum(counts) - counts).to(torch.int32)
    total = torch.tensor([605], dtype=torch.int32)
    j0, count, spill = check_window(offsets, total, 1024)
    assert spill.tolist() == [True, False, False]
    # block 0's two owners lie 301 entries apart
    assert count[0] == 2 and j0.tolist() == [0, 301, 301]


def enumerate_tiles(k):
    """K7's slots for inputs built directly (``tile_window_cases``),
    written out as loops over each Gaussian's rect in depth order."""
    off, base, nx, gid = (k[a].tolist() for a in ("offsets", "base", "nx",
                                                 "gid"))
    tot, gx, n = int(k["total"]), k["grid_x"], len(off)
    tiles, ids = [], []
    for j in range(n):
        end = min(off[j + 1] if j + 1 < n else tot, tot)
        for r in range(max(end - off[j], 0)):
            tiles.append(base[j] + (r // nx[j]) * gx + r % nx[j])
            ids.append(gid[j])
    return np.array(tiles, np.int64), np.array(ids, np.int64)


@pytest.mark.parametrize("case", TILE_CASES)
def test_tile_window_plain_matches_searchsorted(case):
    """K7's partition (persistent blocks staging up to 1,024 slots a step,
    up to eight chunks of entries) where its windows are extreme:
    zero-count runs of 1-300 among the live rects, offsets clamped to the
    capacity at the tail, a capacity that is no multiple of the step, one
    owner over 9+ steps (a rect 300 tiles wide), steps of 1,024 owners, no
    pair at all, and owners spanning exactly the window and one entry more
    (the spill). Also K7's plain version against the rects written out,
    and K1's one-chunk window spilling on the zero-count runs that K7's
    holds."""
    k = PT.tile_window_cases()[case]
    # K7's persistent grid: one block, a few, and the H100's 616 at the
    # full scene's shape (each block's steps start at its share of slots).
    counts, spills = {}, {}
    for grid in (1, 7, 616):
        _, counts[grid], spills[grid] = check_window(
            k["offsets"], k["total"], k["p_cap"], pbin.TILES_STEP,
            pbin.TILES_CHUNKS, grid)
    old = check_window(k["offsets"], k["total"], k["p_cap"])[2]
    tot = int(k["total"])
    tile, gid, hist = pbin.expand_tiles_plain(**k)
    want_t, want_g = enumerate_tiles(k)
    assert want_t.size == tot
    np.testing.assert_array_equal(tile[:tot].numpy(), want_t)
    np.testing.assert_array_equal(gid[:tot].numpy(), want_g)
    assert (tile[tot:] == k["num_tiles"]).all() and (gid[tot:] == -1).all()
    np.testing.assert_array_equal(
        hist.numpy(), np.bincount(want_t, minlength=k["num_tiles"]))
    # One block: steps of 1,024 from slot 0, the second of which holds the
    # owners one entry past the window; every grid spills somewhere there.
    expect = {"spill": [1, 6]}.get(case, [])
    assert spills[1].nonzero().flatten().tolist() == expect
    assert all(bool(sp.any()) == (case == "spill") for sp in spills.values())
    if case in ("zero_runs", "dense"):
        assert old.any()
    if case == "dense":
        assert int(counts[1].max()) == pbin.TILES_STEP
    if case == "empty":
        assert tot == 0 and counts[616].numel() == 0
    if case in ("clamped_tail", "ragged_capacity"):
        assert tot == k["p_cap"] and int(k["offsets"].max()) == k["p_cap"]
    if case == "ragged_capacity":
        assert k["p_cap"] % 4 and k["p_cap"] % pbin.TILES_STEP
    if case == "wide_rect":
        assert int(k["nx"].max()) >= 256


def test_tile_window_holds_the_wide_scene():
    """The chip smoke's wide scene (a 4096x256 camera, 2,000 Gaussians,
    most of them zero-count): under K1's one-chunk window of 256 slots
    four blocks would spill; K7's window spills none."""
    from priordepth_gaussiansplatting_torch.core import transforms
    from priordepth_gaussiansplatting_torch.ops import projection
    g = {a: torch.from_numpy(v) for a, v in PT.wide_gaussians().items()}
    w, h = 4096, 256
    cam = PT.look_at_camera((0.0, 0.0, -2.5), width=w, height=h,
                            device="cpu")
    proj = projection.project_gaussians(
        g["means"], transforms.scaling_rotation_to_cov3d(g["scales"],
                                                         g["quats"]),
        g["opacities"], g["sh"], 3, cam.world_view, cam.full_proj,
        cam.cam_center, w, h, cam.tan_fovx, cam.tan_fovy,
        antialiasing=True)
    x = pbin.tile_inputs(proj, w, h, 1 << 14)
    old = check_window(x["offsets"], x["total"], 1 << 14)[2]
    assert int(old.sum()) == 4
    for grid in (1, 7, 616):
        assert not check_window(x["offsets"], x["total"], 1 << 14,
                                pbin.TILES_STEP, pbin.TILES_CHUNKS,
                                grid)[2].any()
    assert int((x["nx"] == 0).sum()) > 0 and int(x["nx"].max()) >= 256


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
