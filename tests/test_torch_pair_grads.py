"""The backward kernels' plain versions alone, against the JAX package's
kernels in interpret mode, torch autograd and float64 numpy: the
compositor's per-pair backward (K3), the sort-back (K5b) and the
per-Gaussian reduction (K4). Both sides get the same numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.ops import binning as pbin
from priordepth_gaussiansplatting_torch.ops import rasterize as prast
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.core import transforms as jtr
from priordepth_gaussiansplatting_tpu.ops import binning as jbin
from priordepth_gaussiansplatting_tpu.ops import projection as jproj
from priordepth_gaussiansplatting_tpu.ops import rasterize_pallas as rp
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)
EYE = (0.0, 0.0, -2.5)


# --- the compositor's backward alone ---------------------------------------

def _tables(g, wh, eye):
    """The port's and the JAX package's pair tables for the same projected
    Gaussians (JAX's projection, carried across)."""
    cam = JT.look_at_camera(eye, width=wh, height=wh)
    proj_j = jproj.project_gaussians(
        jnp.asarray(g["means"]),
        jtr.scaling_rotation_to_cov3d(jnp.asarray(g["scales"]),
                                      jnp.asarray(g["quats"])),
        jnp.asarray(g["opacities"]), jnp.asarray(g["sh"]), 3,
        cam.world_view, cam.full_proj, cam.cam_center, wh, wh,
        cam.tan_fovx, cam.tan_fovy)
    proj = interop.projected_from_numpy(
        *(np.asarray(getattr(proj_j, f)) for f in
          ("mean2d", "conic", "opacity", "rgb", "depth", "invdepth",
           "radius")), device="cpu")
    table, aux = pbin.bin_sorted_pairs(proj, wh, wh, 8192)
    attrs16, aux_j = jbin.bin_sorted_pairs(proj_j, wh, wh, 8192,
                                           interpret=True, exact_grads=True)
    return table.detach(), aux, attrs16, aux_j


COMPOSITE_SCENES = {
    "sparse": (dict(seed=7, n=96), 64, (0.0, 0.0, -2.5)),
    "dense_overlap": (dict(seed=5, n=128, extent=0.3, scale_range=(0.1, 0.3),
                           opacity_range=(0.9, 0.99)), 48, (0.0, 0.0, -2.0)),
}


@pytest.mark.parametrize("scene", sorted(COMPOSITE_SCENES))
def test_composite_bwd_plain_per_pair(scene):
    kw, wh, eye = COMPOSITE_SCENES[scene]
    kw = dict(kw)
    g = PT.random_gaussians(kw.pop("seed"), kw.pop("n"), **kw)
    table, aux, attrs16, aux_j = _tables(g, wh, eye)
    ts, te = aux["tile_start"], aux["tile_end"]
    grid_x, grid_y = pbin.grid_shape(wh, wh)
    rng = np.random.default_rng(1)
    cts = [rng.standard_normal((c, wh, wh)).astype(np.float32)
           for c in (3, 1, 1)]

    def port_vjp(fwd):
        tab = table.clone().requires_grad_(True)
        color, invd, t_fin, _ = fwd(tab, ts, te, grid_x)
        imgs = [prast.tiles_to_image(color, wh, wh),
                prast.tiles_to_image(invd[None], wh, wh),
                prast.tiles_to_image(t_fin[None], wh, wh)]
        loss = sum((i * torch.from_numpy(c)).sum() for i, c in zip(imgs, cts))
        return torch.autograd.grad(loss, tab)[0].numpy()

    got = port_vjp(prast.composite)                # composite_bwd_plain
    autograd = port_vjp(prast.composite_fwd_plain)  # autograd of the forward
    comp = rp._make_composite(wh, wh, int(attrs16.shape[1]), True)
    tile_ids = jnp.arange(grid_x * grid_y, dtype=jnp.int32)
    _, vjp = jax.vjp(lambda a: comp(a, tile_ids, aux_j["tile_start"],
                                    aux_j["tile_end"]), attrs16)
    want_j = np.asarray(vjp(tuple(jnp.asarray(c) for c in cts))[0])
    nv = int(aux["num_valid"])
    assert nv > 0
    for want, what in ((autograd, "autograd"), (want_j, "jax _bwd_kernel")):
        for r in range(pbin.ATTR_ROWS):
            a, b = got[r, :nv], want[r, :nv]
            tol = 3e-4 * np.abs(b).max() + 2e-3 * np.abs(b)
            close = np.abs(a - b) <= tol
            assert close.mean() >= 0.999, (what, r, close.mean())
    assert np.abs(got[:, nv:]).max() == 0.0
    # K3's count of evaluated pairs is K2's
    _, n_eval = prast.composite_bwd(
        table, ts, te, grid_x, *(torch.zeros(s) for s in
                                 ((3, grid_x * grid_y, 256),
                                  (grid_x * grid_y, 256),
                                  (grid_x * grid_y, 256))),
        *prast.composite_fwd(table, ts, te, grid_x)[:3])
    np.testing.assert_array_equal(
        n_eval.numpy(), prast.composite_fwd(table, ts, te, grid_x)[3].numpy())


# --- the per-Gaussian reduction (K4) and the sort-back (K5b) ---------------

def test_segment_reduce_matches_numpy_and_jax():
    """tests/test_pallas_vs_oracle.py::test_segment_reduce_matches_numpy's
    case: 700 Gaussians (some behind the camera, so with no pairs)."""
    n, wh = 700, 96
    g = PT.random_gaussians(11, n, scale_range=(0.0, 0.08))
    g["means"][::13, 2] = -10.0
    cam = JT.look_at_camera(EYE, width=wh, height=wh)
    proj_j = jproj.project_gaussians(
        jnp.asarray(g["means"]),
        jtr.scaling_rotation_to_cov3d(jnp.asarray(g["scales"]),
                                      jnp.asarray(g["quats"])),
        jnp.asarray(g["opacities"]), jnp.asarray(g["sh"]), 3,
        cam.world_view, cam.full_proj, cam.cam_center, wh, wh,
        cam.tan_fovx, cam.tan_fovy)
    b = jbin.bin_gaussians(proj_j, wh, wh, pair_capacity=1 << 15)
    npairs = int(b.num_pairs)
    gids = np.asarray(b.gauss_ids)[:1 << 15].astype(np.int32)
    counts = np.bincount(gids[:npairs], minlength=n)
    assert (counts == 0).any()
    d_np = np.random.default_rng(0).standard_normal(
        (pbin.ATTR_ROWS, 1 << 15)).astype(np.float32)
    truth = np.zeros((pbin.ATTR_ROWS, n))
    np.add.at(truth.T, gids[:npairs], d_np[:, :npairs].T.astype(np.float64))

    key = gids.copy()
    key[npairs:] = n
    perm = np.argsort(key, kind="stable")
    num_valid = torch.tensor(npairs, dtype=torch.int32)
    got = pbin.segment_reduce(torch.from_numpy(d_np[:, perm].copy()),
                              torch.from_numpy(key[perm].copy()), num_valid,
                              n).numpy()
    want_j = np.asarray(jbin.segment_reduce(
        jnp.asarray(d_np[:, perm]), jnp.asarray(key[perm]), b.num_pairs, n,
        interpret=True))
    for want in (truth, want_j):
        np.testing.assert_allclose(got, want, atol=2e-4)
    assert got.shape == (pbin.ATTR_ROWS, n)
    assert np.abs(got[:, counts == 0]).max() == 0.0

    # the whole backward of the binning: keys in tile order, sort-back
    # (K5b) then K4, from a table with padding columns past v
    table = np.concatenate([d_np, np.ones((pbin.ATTR_ROWS, 64), np.float32)],
                           axis=1)
    got = pbin.pair_grads_to_gaussians(
        torch.from_numpy(table), torch.from_numpy(gids), num_valid, n)
    np.testing.assert_allclose(got.numpy(), truth, atol=2e-4)


def test_sort_back_rows_is_a_gather():
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((10, 300), dtype=np.float32))
    key = torch.from_numpy(rng.integers(0, 50, 256, dtype=np.int32))
    key_sorted, perm = torch.sort(key, stable=True)
    d_sorted = pbin.sort_back_rows(table, perm)
    assert torch.equal(d_sorted, table[:, perm])
    assert torch.equal(key_sorted, key[perm])


@pytest.mark.parametrize("v", [1, 255, 1024])
def test_sort_back_rows_plain_equals_gather_rows_plain(v):
    """K5b's plain version, without the id row, moves the rows K5a's plain
    version moves; the sort's values are the key it no longer gathers
    (ties and padding ids = n)."""
    n = 40
    rng = np.random.default_rng(v)
    table = torch.from_numpy(
        rng.standard_normal((pbin.ATTR_ROWS, v + 1024), dtype=np.float32))
    key = torch.from_numpy(rng.integers(0, n + 1, v, dtype=np.int32))
    key_sorted, perm = torch.sort(key, stable=True)
    rows, key_out = pbin.gather_rows_plain(table, key, perm, v, v)
    for got in (pbin.sort_back_rows(table, perm),
                pbin.sort_back_rows_plain(table, perm)):
        assert torch.equal(got.view(torch.int32), rows.view(torch.int32))
    assert torch.equal(key_sorted, key_out)


@pytest.mark.parametrize("v", [301, 1023])
def test_pair_grads_to_gaussians_matches_jax_bin_sorted_bwd(v):
    """The binning's backward, K4 reading the stable sort's values as the
    sorted key, against JAX's ``_bin_sorted_bwd`` (exact f32 routing,
    interpret mode) and a float64 sum: an odd v with padding columns past
    it (ones, which must not reach any Gaussian), positions from num_valid
    on keyed n, and Gaussians without pairs."""
    n, pad = 97, 64
    rng = np.random.default_rng(v)
    gid_sorted = rng.integers(0, n - 7, v, dtype=np.int32)
    num_valid = v - 11
    table = np.concatenate(
        [rng.standard_normal((pbin.ATTR_ROWS, v), dtype=np.float32),
         np.ones((pbin.ATTR_ROWS, pad), np.float32)], axis=1)
    got = pbin.pair_grads_to_gaussians(
        torch.from_numpy(table), torch.from_numpy(gid_sorted),
        torch.tensor(num_valid, dtype=torch.int32), n).numpy()

    v_pad = 1024 * -(-(v + pad) // 1024)
    d16 = np.zeros((16, v_pad), np.float32)
    d16[:pbin.ATTR_ROWS, :v + pad] = table
    spec = (64, 64, v_pad, v, True, True)
    res = (pbin.ATTR_ROWS, n, (n,), (1,), (1,), jnp.asarray(gid_sorted),
           jnp.int32(num_valid))
    want_j = np.asarray(jbin._bin_sorted_bwd(spec, res,
                                             (jnp.asarray(d16),))[0])
    truth = np.zeros((pbin.ATTR_ROWS, n))
    np.add.at(truth.T, gid_sorted[:num_valid],
              table[:, :num_valid].T.astype(np.float64))
    assert got.shape == want_j.shape == (pbin.ATTR_ROWS, n)
    for want in (want_j, truth):
        np.testing.assert_allclose(got, want, atol=2e-4)
    assert np.abs(got[:, n - 7:]).max() == 0.0


def _k4_case(num_tiles=6700):
    """K4's edge cases in one id-sorted key: one Gaussian covering every
    tile of the full scene's frame (6,700 pairs), Gaussians with no pairs
    (the first ids, ids between, the last ids), num_valid cutting a
    segment, and padding keys == n past it."""
    rng = np.random.default_rng(21)
    n = 700
    counts = np.zeros(n, np.int64)
    live = rng.choice(np.arange(3, n - 5), 300, replace=False)
    counts[live] = rng.integers(1, 40, 300)
    counts[live[0]] = num_tiles
    key = np.repeat(np.arange(n), counts)
    cut = int(np.searchsorted(key, live.max())) + 3  # inside its segment
    assert key[cut - 1] == key[cut] == live.max()
    v = key.size + 37
    key = np.concatenate([key, np.full(37, n)]).astype(np.int32)
    d = rng.standard_normal((pbin.ATTR_ROWS, v)).astype(np.float32)
    return d, key, cut, n


def test_segment_reduce_plain_edge_cases_match_jax_and_numpy():
    """K4's plain version, and the binning's backward through it, against
    JAX's segment_reduce (interpret mode) and a float64 numpy sum; the
    Gaussians without pairs and those cut off by num_valid get exactly 0."""
    d, key, cut, n = _k4_case()
    truth = np.zeros((pbin.ATTR_ROWS, n))
    np.add.at(truth.T, key[:cut], d[:, :cut].T.astype(np.float64))
    num_valid = torch.tensor(cut, dtype=torch.int32)
    got = pbin.segment_reduce_plain(torch.from_numpy(d), torch.from_numpy(key),
                                    num_valid, n).numpy()
    want_j = np.asarray(jbin.segment_reduce(
        jnp.asarray(d), jnp.asarray(key), jnp.int32(cut), n, interpret=True))
    scale = np.abs(truth).max(1, keepdims=True)
    assert np.abs(got - truth).max() <= 1e-6 * scale.max()
    assert (np.abs(got - want_j) <= 1e-5 * scale).all()
    empty = np.bincount(key[:cut], minlength=n + 1)[:n] == 0
    assert empty.sum() > 300 and not got[:, empty].any()

    # The backward from a tile-ordered table: the valid pairs shuffled, any
    # ids past num_valid, and ones in padding columns past v; neither of
    # the last two may reach a Gaussian.
    rng = np.random.default_rng(22)
    order = rng.permutation(cut)
    gid_tiles = np.concatenate([key[:cut][order], rng.integers(
        0, n, key.size - cut)]).astype(np.int32)
    table = np.concatenate([d[:, order], d[:, cut:],
                            np.ones((pbin.ATTR_ROWS, 64), np.float32)],
                           axis=1)
    got = pbin.pair_grads_to_gaussians(
        torch.from_numpy(table), torch.from_numpy(gid_tiles), num_valid,
        n).numpy()
    assert np.abs(got - truth).max() <= 1e-6 * scale.max()
    assert not got[:, empty].any()


@pytest.mark.parametrize("case", ["random", "one_long_segment"])
def test_segment_bounds_is_k4_block_partition(case):
    """The plain form of K4's partition (block b owns the ids [b G, b G +
    G) and reads the columns [bounds[b], bounds[b + 1])) against a direct
    enumeration, at K4's ids per block and at 1 (every Gaussian's segment
    start): the blocks' columns are exactly the positions below num_valid
    whose key is one of their ids, in order, on random keys and on one
    segment longer than any of the kernel's passes of 1,024 columns."""
    if case == "random":
        rng = np.random.default_rng(5)
        n, v = 3000, 20_000
        key = np.sort(rng.integers(0, n + 1, v)).astype(np.int32)
        num_valid = v - 777
    else:
        d, key, num_valid, n = _k4_case()
        v = key.size
        assert np.bincount(key).max() == 6700
    pos = np.arange(v)
    for ids in (1, 32, pbin.segment_ids_per_block(n, v), 1024):
        bounds = pbin.segment_bounds(torch.from_numpy(key),
                                     torch.tensor(num_valid), n, ids).numpy()
        nb = -(-n // ids)
        assert bounds.shape == (nb + 1,)
        for b in range(nb):
            mine = pos[(pos < num_valid) & (key >= b * ids)
                       & (key < min(b * ids + ids, n))]
            np.testing.assert_array_equal(
                mine, np.arange(bounds[b], bounds[b + 1]))
        assert bounds[-1] == int(((pos < num_valid) & (key < n)).sum())


def test_segment_ids_per_block():
    """K4's ids per block: a power of two in [32, 1024], 1,024 for the full
    scene's ~2.6 key slots per Gaussian, 128 for the mid scene's ~17."""
    assert pbin.segment_ids_per_block(1_000_000, 2_621_440) == 1024
    assert pbin.segment_ids_per_block(131_072, 2_228_224) == 128
    assert pbin.segment_ids_per_block(10, 10**7) == 32
    assert pbin.segment_ids_per_block(10**6, 1) == pbin.SEGMENT_MAX_IDS
