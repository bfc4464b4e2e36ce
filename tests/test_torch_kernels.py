"""The CUDA kernels against their plain PyTorch versions on the card, at a
small size. These need a CUDA card and skip elsewhere. The file imports
neither jax nor the JAX package, so it also runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import kernels
from priordepth_gaussiansplatting_torch.core import transforms
from priordepth_gaussiansplatting_torch.ops import binning, projection
from priordepth_gaussiansplatting_torch.ops import rasterize
from priordepth_gaussiansplatting_torch.utils import testing as PT

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _projected(card, n=2048, wh=256):
    g = PT.random_gaussians(17, n)
    cam = PT.look_at_camera((0, 0, -2.5), width=wh, height=wh, device=card)
    t = {k: torch.from_numpy(v).to(card) for k, v in g.items()}
    return projection.project_gaussians(
        t["means"], transforms.scaling_rotation_to_cov3d(t["scales"],
                                                         t["quats"]),
        t["opacities"], t["sh"], 3, cam.world_view, cam.full_proj,
        cam.cam_center, wh, wh, cam.tan_fovx, cam.tan_fovy,
        antialiasing=True)


@pytest.mark.parametrize("slack", [512, -256])
def test_expand_pairs_kernel_equals_plain(card, slack):
    proj = _projected(card)
    rects = binning.depth_sorted_rects(proj, 256, 256)
    k = dict(rects, p_cap=max(int(rects["total"]) + slack, 256), grid_x=16,
             num_tiles=256)
    before = kernels.launch_counts()["expand_pairs"]
    got = binning.expand_pairs(**k)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["expand_pairs"] == before + 1
    want = binning.expand_pairs_plain(**k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def test_gather_rows_kernel_equals_plain(card):
    rng = np.random.default_rng(0)
    p, v_cap = 5000, 3072
    src = torch.from_numpy(rng.standard_normal((10, p), dtype=np.float32)).to(card)
    gid = torch.from_numpy(rng.integers(0, 999, p, dtype=np.int32)).to(card)
    perm = torch.from_numpy(rng.permutation(p)).to(card)
    got = binning.gather_rows(src, gid, perm, v_cap, v_cap + 1024)
    want = binning.gather_rows_plain(src, gid, perm, v_cap, v_cap + 1024)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (p, v_cap, out_len): v_cap and out_len not multiples of 4 (rows that
# start off 16 bytes), v_cap < p with K5a's zero tail, v = 1, v_cap = p.
GATHER_SHAPES = [(5001, 3071, 4095), (5000, 3072, 4096), (7, 1, 1025),
                 (4096, 4096, 5120), (70_001, 65_537, 66_561)]


@pytest.mark.parametrize("rows_per_pass", [1, 2, 11])
@pytest.mark.parametrize("shape", GATHER_SHAPES)
def test_gather_rows_kernel_bit_equal_at_ragged_shapes(card, monkeypatch,
                                                       shape,
                                                       rows_per_pass):
    """K5a against its plain version bit for bit (table, zero tail, ids)
    with one launch, at shapes the main path's capacities (multiples of
    4096) never give, and with the rows walked 1, 2 or 11 per pass."""
    monkeypatch.setattr(binning, "GATHER_ROWS_PER_PASS", rows_per_pass)
    p, v_cap, out_len = shape
    rng = np.random.default_rng(p)
    src = torch.from_numpy(
        rng.standard_normal((10, p), dtype=np.float32)).to(card)
    src[0, :3] = torch.tensor([-0.0, float("inf"), float("nan")])
    gid = torch.from_numpy(rng.integers(0, 999, p, dtype=np.int32)).to(card)
    perm = torch.from_numpy(rng.permutation(p)).to(card)
    before = kernels.launch_counts()
    got = binning.gather_rows(src, gid, perm, v_cap, out_len)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gather_rows"] == before["gather_rows"] + 1
    assert after["gather_rows_bwd"] == before["gather_rows_bwd"]
    want = binning.gather_rows_plain(src, gid, perm, v_cap, out_len)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))
    assert int(got[0][:, v_cap:].view(torch.int32).abs().max()) == 0


@pytest.mark.parametrize("v", [1, 4097, 50_001])
def test_sort_back_kernel_bit_equal_with_ties_and_padding(card, v):
    """K5b against its plain version bit for bit with one launch: a key
    with ties and padding ids = n, v not a multiple of 4, a gradient table
    wider than v; the sorted key is the sort's values."""
    n = max(v // 3, 1)
    rng = np.random.default_rng(v)
    key = torch.from_numpy(rng.integers(0, n + 1, v, dtype=np.int32)).to(card)
    key[-min(v, 5):] = n
    d_table = torch.from_numpy(
        rng.standard_normal((10, v + 1024), dtype=np.float32)).to(card)
    key_sorted, perm = torch.sort(key, stable=True)
    before = kernels.launch_counts()
    got = binning.sort_back_rows(d_table, perm)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gather_rows_bwd"] == before["gather_rows_bwd"] + 1
    assert after["gather_rows"] == before["gather_rows"]
    want = binning.sort_back_rows_plain(d_table, perm)
    assert got.shape == (10, v) and torch.equal(_bits(got), _bits(want))
    assert torch.equal(key_sorted, key[perm])


def test_gather_kernels_refuse_an_index_off_16_bytes(card):
    d_table = torch.zeros(10, 2048, device=card)
    perm = torch.arange(1025, device=card)
    with pytest.raises(ValueError, match="16 bytes"):
        binning.sort_back_rows(d_table, perm[1:])


def test_binning_step_launches_each_gather_once(card, monkeypatch):
    """The binning forward and backward: K1, K5a, K5b and K4 once each and
    no other kernel; the gradients equal those with K1, K5a and K5b
    replaced by their plain versions bit for bit (K4, deterministic, runs
    in both)."""
    proj = _projected(card)
    w = torch.randn(10, (1 << 16) + binning.COMPOSITE_PAD, device=card,
                    generator=torch.Generator(device=card).manual_seed(3))

    def grads():
        leaves = {k: getattr(proj, k).detach().requires_grad_(True)
                  for k in ("mean2d", "conic", "opacity", "rgb", "invdepth")}
        table, _ = binning.bin_sorted_pairs(proj.replace(**leaves), 256, 256,
                                            1 << 16)
        return torch.autograd.grad((table * w).sum(), list(leaves.values()))

    before = kernels.launch_counts()
    got = grads()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    assert delta == {k: int(k in ("expand_pairs", "gather_rows",
                                  "gather_rows_bwd", "segment_reduce"))
                     for k in after}, delta
    for name in ("expand_pairs", "gather_rows", "sort_back_rows"):
        monkeypatch.setattr(binning, name, getattr(binning, f"{name}_plain"))
    for g, w_ in zip(got, grads()):
        assert torch.equal(_bits(g), _bits(w_))


def test_composite_kernel_matches_plain(card):
    proj = _projected(card)
    table, aux = binning.bin_sorted_pairs(proj, 256, 256, 1 << 16)
    got = rasterize.composite_fwd(table, aux["tile_start"], aux["tile_end"],
                                  16)
    want = rasterize.composite_fwd_plain(table, aux["tile_start"],
                                         aux["tile_end"], 16)
    for g, w in zip(got[:3], want[:3]):
        diff = (g - w).abs()
        assert (diff <= 2e-5).float().mean() >= 0.999
        assert diff.max() <= 5e-3
    assert (got[3] == want[3]).float().mean() >= 0.999


def test_composite_bwd_kernel_matches_plain(card):
    proj = _projected(card)
    table, aux = binning.bin_sorted_pairs(proj, 256, 256, 1 << 16)
    ts, te = aux["tile_start"], aux["tile_end"]
    color, invd, t_fin, n_eval = rasterize.composite_fwd(table, ts, te, 16)
    gen = torch.Generator(device=card).manual_seed(0)
    cts = [torch.randn(s, generator=gen, device=card)
           for s in (color.shape, invd.shape, t_fin.shape)]
    args = (table, ts, te, 16, *cts, color, invd, t_fin)
    before = kernels.launch_counts()["composite_bwd"]
    got, got_eval = rasterize.composite_bwd(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["composite_bwd"] == before + 1
    want, want_eval = rasterize.composite_bwd_plain(*args)
    assert (got_eval == n_eval).float().mean() >= 0.999
    assert (want_eval == n_eval).float().mean() >= 0.999
    nv = int(aux["num_valid"])
    for r in range(binning.ATTR_ROWS):
        a, b = got[r, :nv], want[r, :nv]
        tol = 3e-4 * b.abs().max() + 2e-3 * b.abs()
        assert ((a - b).abs() <= tol).float().mean() >= 0.999, r
    assert float(got[:, nv:].abs().max()) == 0.0


def test_sort_back_and_segment_reduce_kernels_equal_plain(card):
    rng = np.random.default_rng(1)
    n, v = 3000, 50_000
    key = torch.from_numpy(rng.integers(0, n + 1, v, dtype=np.int32)).to(card)
    d_table = torch.from_numpy(
        rng.standard_normal((10, v + 1024), dtype=np.float32)).to(card)
    key_sorted, perm = torch.sort(key, stable=True)
    before = kernels.launch_counts()
    d_sorted = binning.sort_back_rows(d_table, perm)
    want = binning.gather_rows_plain(d_table, key, perm, v, v)
    assert torch.equal(d_sorted, want[0]) and torch.equal(key_sorted, want[1])
    num_valid = torch.tensor(v - 777, dtype=torch.int32, device=card)
    got = binning.segment_reduce(d_sorted, key_sorted, num_valid, n)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gather_rows_bwd"] == before["gather_rows_bwd"] + 1
    assert after["gather_rows"] == before["gather_rows"]
    assert after["segment_reduce"] == before["segment_reduce"] + 1
    want = binning.segment_reduce_plain(d_sorted, key_sorted, num_valid, n)
    scale = want.abs().amax(1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


def _segments(case):
    """An id-sorted key for K4 with its n and num_valid (int32 numpy)."""
    rng = np.random.default_rng(13)
    if case == "lengths":
        # Segment lengths 1 ... 6,700 (the full scene's tiles) that cross
        # the kernel's thread (4), warp (128) and pass (1,024) boundaries,
        # every 7th id and the first 5 and last 7 without pairs, num_valid
        # in the middle of the 6,700 segment.
        cycle = [1, 2, 3, 4, 5, 7, 31, 33, 127, 128, 129, 1023, 1024, 1025,
                 2049, 6700]
        n = 400
        lengths = np.array([cycle[i % len(cycle)] for i in range(n)])
        lengths[::7] = 0
        lengths[:5] = 0
        lengths[-7:] = 0
        key = np.repeat(np.arange(n), lengths)
        long_id = int(np.flatnonzero(lengths == 6700)[-1])
        num_valid = int(np.searchsorted(key, long_id)) + 3333
    else:
        # Many short segments: blocks of the most ids.
        n = 200_000
        key = np.repeat(np.arange(n), rng.integers(0, 4, n))
        num_valid = key.size - 5
    return key.astype(np.int32), n, num_valid


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("case", ["lengths", "short"])
def test_segment_reduce_kernel_edge_cases(card, case, pad):
    """K4 within 1e-5 x row max of its plain version (float64 sums) and bit
    for bit across two launches, at segment lengths 1 ... 6,700, with ids
    without pairs first, between and last, num_valid inside a segment and
    padding keys == n after it; 16-byte loads (v % 4 == 0) and scalar
    ones."""
    key, n, num_valid = _segments(case)
    v = key.size + 20
    v += (4 - v % 4) % 4 + pad * 3
    key = np.concatenate([key, np.full(v - key.size, n, np.int32)])
    rng = np.random.default_rng(pad)
    d = torch.from_numpy(rng.standard_normal((10, v), dtype=np.float32))
    k = torch.from_numpy(key)
    nv = torch.tensor(num_valid, dtype=torch.int32)
    want = binning.segment_reduce_plain(d, k, nv, n).to(card)
    d, k, nv = d.to(card), k.to(card), nv.to(card)
    before = kernels.launch_counts()["segment_reduce"]
    got = binning.segment_reduce(d, k, nv, n)
    again = binning.segment_reduce(d, k, nv, n)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["segment_reduce"] == before + 2
    assert torch.equal(_bits(got), _bits(again))
    scale = want.abs().amax(1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    empty = torch.bincount(k[:num_valid].long(), minlength=n + 1)[:n] == 0
    assert int(empty.sum()) > 0 and float(got[:, empty].abs().max()) == 0.0


def _rects(case):
    """K1's inputs on a 300 x 100 tile grid, built directly: depth-ordered
    rects (live first, zero-count rects at the tail), random attributes
    that keep some pairs and cull others, and the pair capacity."""
    rng = np.random.default_rng(31)
    grid_x, grid_y = 300, 100
    if case == "long_and_dense":
        # a rect 280 tiles wide over 26+ blocks of 256 slots, 1-tile rects
        # (blocks spanning 200+ owners), then mixed ones; a 1.1x capacity
        widths = np.concatenate([rng.integers(1, 4, 300), [280],
                                 np.ones(900, np.int64),
                                 rng.integers(1, 12, 200)])
        heights = np.concatenate([rng.integers(1, 3, 300), [24],
                                  np.ones(900, np.int64),
                                  rng.integers(1, 6, 200)])
    else:
        widths = rng.integers(1, 9, 700)
        heights = rng.integers(1, 9, 700)
    if case == "spill":
        # 300 zero-width rects among the live ones (offsets that do not
        # ascend strictly): more owners before a block's last slot than
        # it has threads, so the block searches in device memory.
        widths[5:305] = 0
    n_live = widths.size
    n = n_live + 50
    x0 = rng.integers(0, grid_x - widths + 1)
    y0 = rng.integers(0, grid_y - heights + 1)
    counts = np.concatenate([widths * heights, np.zeros(50, np.int64)])
    offsets = np.cumsum(counts) - counts
    total = int(counts.sum())
    p_cap = total - 999 if case == "ragged" else int(total * 1.1)
    base = np.concatenate([y0 * grid_x + x0, np.zeros(50, np.int64)])
    nx = np.concatenate([widths, np.zeros(50, np.int64)])
    attrs = np.zeros((10, n), np.float32)
    attrs[0, :n_live] = (x0 + widths * rng.uniform(0, 1, n_live)) * 16
    attrs[1, :n_live] = (y0 + heights * rng.uniform(0, 1, n_live)) * 16
    sx = (np.maximum(widths, 1) * 16 / 3) ** -2
    sy = (heights * 16 / 3) ** -2
    attrs[2, :n_live] = sx
    attrs[3, :n_live] = rng.uniform(-0.3, 0.3, n_live) * np.sqrt(sx * sy)
    attrs[4, :n_live] = sy
    attrs[5, :n_live] = rng.uniform(0.01, 0.99, n_live)
    attrs[6:, :n_live] = rng.uniform(0, 1, (4, n_live))
    i32 = torch.int32
    return dict(offsets=torch.from_numpy(offsets).to(i32),
                base=torch.from_numpy(base).to(i32),
                nx=torch.from_numpy(nx).to(i32),
                gid=torch.from_numpy(rng.permutation(n)).to(i32),
                attrs=torch.from_numpy(attrs),
                total=torch.tensor([total], dtype=i32),
                p_cap=p_cap, grid_x=grid_x, num_tiles=grid_x * grid_y)


@pytest.mark.parametrize("case", ["long_and_dense", "ragged", "spill"])
def test_expand_pairs_kernel_owner_windows(card, case):
    """K1 against its plain version where its blocks' owner windows are
    extreme: one owner over 26+ blocks (a rect 280 tiles wide), blocks of
    200+ owners, zero-count rects at the tail, a capacity above the total
    (padding blocks) and below it (a cut rect, a ragged last block), and
    zero-count rects among the live ones (a window that spills). Ids,
    attributes and histogram bit for bit; tiles equal except culls within
    one f32 ulp of the cull limit."""
    k = _rects(case)
    want = binning.expand_pairs_plain(**k)
    k = {a: x.to(card) if isinstance(x, torch.Tensor) else x
         for a, x in k.items()}
    got = binning.expand_pairs(**k)
    torch.cuda.synchronize()
    tile, gid, attrs, hist = (x.cpu() for x in got)
    assert torch.equal(gid, want[1])
    assert torch.equal(_bits(attrs), _bits(want[2]))
    num_tiles = k["num_tiles"]
    assert torch.equal(hist, torch.bincount(
        tile[tile < num_tiles].long(), minlength=num_tiles).to(torch.int32))
    flips = tile != want[0]
    assert int(flips.sum()) <= 2
    if bool(flips.any()):
        real = torch.where(tile == num_tiles, want[0], tile)[flips]
        qmin, limit = binning.cull_terms(real, attrs[:, flips], k["grid_x"])
        ulp = torch.nextafter(limit, torch.full_like(limit, float("inf")))
        assert bool(((qmin - limit).abs() <= ulp - limit).all())
    kept = int((tile < num_tiles).sum())
    assert 0 < kept < min(int(k["total"]), k["p_cap"])


@pytest.mark.parametrize("grid_y", [34, 100])
@pytest.mark.parametrize("case", ["zero_runs", "clamped_tail",
                                  "ragged_capacity", "wide_rect", "dense",
                                  "empty", "spill"])
def test_expand_tiles_kernel_owner_windows(card, case, grid_y):
    """K7 against its plain version where its blocks' owner windows are
    extreme (``utils/testing.py::tile_window_cases``): zero-count runs of
    1-300 among the live rects, offsets clamped to the capacity at the
    tail, a capacity that is no multiple of the block nor of four slots, a
    rect 300 tiles wide over 9+ blocks, blocks of 1,024 owners, no pair at
    all, and blocks whose owners span the window and one entry more (they
    search in device memory); on 300 x 34 tiles (the histogram in shared
    memory) and 300 x 100 (in device memory). Tiles, ids (padding slots
    included) and histogram bit for bit, one launch, twice over one output
    buffer reused (the kernel zeroes the histogram itself)."""
    k = PT.tile_window_cases(grid_y)[case]
    want = binning.expand_tiles_plain(**k)
    shape = binning.expand_tiles_grid(k["p_cap"], k["num_tiles"])
    assert shape["shared_hist"] == (grid_y == 34)
    spill = binning.owner_window_plain(k["offsets"], k["total"], k["p_cap"],
                                       binning.TILES_STEP,
                                       binning.TILES_CHUNKS,
                                       shape["grid"])[2]
    assert bool(spill.any()) == (case == "spill")
    k = {a: x.to(card) if isinstance(x, torch.Tensor) else x
         for a, x in k.items()}
    before = kernels.launch_counts()["expand_tiles"]
    got = binning.expand_tiles(**k)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["expand_tiles"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    del got  # the caching allocator hands the same memory to the next call
    again = binning.expand_tiles(**k)
    torch.cuda.synchronize()
    for g, w in zip(again, want):
        assert torch.equal(g.cpu(), w)


def test_rasterize_gradients_on_card_match_cpu(card):
    proj = _projected(card)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)

    def grads(p, b):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in vars(p).items() if v.is_floating_point()}
        out = rasterize.rasterize(p.replace(**leaves), b, 256, 256)
        loss = (out["render"].square().mean()
                + 0.1 * out["invdepth"].abs().mean())
        return dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))

    before = kernels.launch_counts()
    got = grads(proj, bg)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("composite_bwd", "gather_rows_bwd", "segment_reduce"):
        assert after[name] == before[name] + 1, name
    want = grads(projection.ProjectedGaussians(
        **{k: v.cpu() for k, v in vars(proj).items()}), bg.cpu())
    for k in ("mean2d", "conic", "opacity", "rgb", "invdepth"):
        g, w = got[k].cpu(), want[k]
        assert bool(torch.isfinite(g).all()), k
        torch.testing.assert_close(g, w, atol=3e-4 * float(w.abs().max()),
                                   rtol=2e-3)


def test_rasterize_on_card_matches_cpu(card):
    proj = _projected(card)
    bg = torch.tensor([0.1, 0.2, 0.3], device=card)
    got = rasterize.rasterize(proj, bg, 256, 256)
    cpu = projection.ProjectedGaussians(
        **{k: v.cpu() for k, v in vars(proj).items()})
    want = rasterize.rasterize(cpu, bg.cpu(), 256, 256)
    assert int(got["num_pairs"]) == int(want["num_pairs"])
    diff = (got["render"].cpu() - want["render"]).abs()
    assert (diff <= 2e-5).float().mean() >= 0.999 and diff.max() <= 5e-3


@pytest.mark.parametrize("n_bands", [3, 4])
def test_band_kernels_match_plain_and_the_frame(card, n_bands):
    """K6 band by band (256 tiles: 3 bands of 86 slots with 2 pads, or 4 of
    64): each band against its plain version, the assembled bands equal to
    K2's frame and the summed band tables to K3's."""
    proj = _projected(card)
    table, aux = binning.bin_sorted_pairs(proj, 256, 256, 1 << 16)
    ts, te = aux["tile_start"], aux["tile_end"]
    color, invd, t_fin, _ = rasterize.composite_fwd(table, ts, te, 16)
    gen = torch.Generator(device=card).manual_seed(1)
    cts = [torch.randn(s, generator=gen, device=card)
           for s in (color.shape, invd.shape, t_fin.shape)]
    d_whole, _ = rasterize.composite_bwd(table, ts, te, 16, *cts, color,
                                         invd, t_fin)
    size = -(-256 // n_bands)
    outs, d_sum = [], torch.zeros_like(table)
    for m in range(n_bands):
        ids, start, end = rasterize.band_slots(ts, te, n_bands, m)
        real = torch.arange(size, device=card) + m * size < 256
        band_cts = [c[..., ids.long(), :] * real[:, None] for c in cts]
        before = kernels.launch_counts()
        fwd = rasterize.composite_fwd_bands(table, start, end, 16, ids)
        args = (table, start, end, 16, ids, *band_cts, *fwd[:3])
        d_band, n_eval = rasterize.composite_bwd_bands(*args)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        for name in ("composite_fwd_bands", "composite_bwd_bands"):
            assert after[name] == before[name] + 1, name
        assert after["composite_fwd"] == before["composite_fwd"]
        want = rasterize.composite_fwd_bands_plain(table, start, end, 16, ids)
        for g, w in zip(fwd[:3], want[:3]):
            diff = (g - w).abs()
            assert (diff <= 2e-5).float().mean() >= 0.999
            assert diff.max() <= 5e-3
        assert torch.equal(n_eval, fwd[3])
        d_plain, _ = rasterize.composite_bwd_bands_plain(*args)
        for r in range(binning.ATTR_ROWS):
            a, b = d_band[r], d_plain[r]
            tol = 3e-4 * b.abs().max() + 2e-3 * b.abs()
            assert ((a - b).abs() <= tol).float().mean() >= 0.999, r
        outs.append(fwd[:3])
        d_sum = d_sum + d_band
    got = torch.cat([o[0] for o in outs], 1)[:, :256]
    assert torch.equal(got, color)
    assert torch.equal(torch.cat([o[2] for o in outs])[:256], t_fin)
    assert torch.equal(d_sum, d_whole)


# Tile sizes around the compositor's chunks of 32 pairs and batches of 128
# (and the 256 of its first design), then two built tiles: "opaque", whose
# pixels all stop within the first batch, and "stops", where one pixel stops
# on the last pair of the first batch and another on the last of the second.
RANGE_SIZES = (0, 1, 31, 32, 33, 127, 128, 129, 255, 256, 257, 600)
RANGE_GRID_X = 4


def _conics(rng, n, sigma):
    """Conics (a, b, c) of n rotated Gaussians with the given axis sigmas
    (2, n) plus the rasterizer's 0.3 px^2 low-pass."""
    th = rng.uniform(0.0, np.pi, n)
    cos, sin = np.cos(th), np.sin(th)
    sx2, sy2 = sigma[0] ** 2, sigma[1] ** 2
    cxx = cos * cos * sx2 + sin * sin * sy2 + 0.3
    cyy = sin * sin * sx2 + cos * cos * sy2 + 0.3
    cxy = cos * sin * (sx2 - sy2)
    det = cxx * cyy - cxy * cxy
    return cyy / det, -cxy / det, cxx / det


def _range_table(card):
    """A (ATTR_ROWS, L) pair table over a 4x4 grid of tiles (RANGE_SIZES,
    then the opaque and the stopping tile, then two empty ones) with its
    tile ranges; means scattered over each tile and 8 px around it, axis
    sigmas 0.3-6 px with some 20 px streaks (conics outside the warp-row
    bound), opacities 0.02-0.99 with some at the 1/255 cut-off."""
    rng = np.random.default_rng(5)
    cols, starts, ends, pos = [], [], [], 0
    for t, n in enumerate(RANGE_SIZES + (300, 300)):
        ty, tx = divmod(t, RANGE_GRID_X)
        x0, y0 = 16.0 * tx, 16.0 * ty
        sigma = rng.uniform(0.3, 6.0, (2, n))
        sigma[0, rng.random(n) < 0.1] = 20.0
        op = rng.uniform(0.02, 0.99, n)
        op[rng.random(n) < 0.05] = 1.0 / 255.0
        mx = x0 + rng.uniform(-8.0, 24.0, n)
        my = y0 + rng.uniform(-8.0, 24.0, n)
        if t == len(RANGE_SIZES):            # opaque: wide, near-opaque
            sigma[:] = 40.0
            op[:] = 0.99
            mx, my = x0 + 7.5 + 0 * mx, y0 + 7.5 + 0 * my
        elif t == len(RANGE_SIZES) + 1:      # stops: transparent but four
            op[:] = 0.0
            for k, (cx, cy) in ((126, (3, 5)), (127, (3, 5)),
                                (254, (12, 9)), (255, (12, 9))):
                op[k], mx[k], my[k] = 0.99, x0 + cx, y0 + cy
        a, b, c = _conics(rng, n, sigma)
        block = np.stack([mx, my, a, b, c, op,
                          *rng.random((3, n)), rng.uniform(0.2, 2.0, n)])
        cols.append(block.astype(np.float32))
        starts.append(pos)
        pos += n
        ends.append(pos)
    n_tiles = RANGE_GRID_X * RANGE_GRID_X
    starts += [pos] * (n_tiles - len(starts))
    ends += [pos] * (n_tiles - len(ends))
    table = np.concatenate(cols + [np.zeros((10, 64), np.float32)], 1)
    return (torch.as_tensor(table, device=card),
            torch.tensor(starts, dtype=torch.int32, device=card),
            torch.tensor(ends, dtype=torch.int32, device=card))


def _rows_within(got, want):
    """Each row's share of entries within the gradient rule."""
    tol = 3e-4 * want.abs().amax(1, keepdim=True) + 2e-3 * want.abs()
    return ((got - want).abs() <= tol).float().mean(1)


def test_composite_kernels_at_batch_boundaries(card):
    """K2 and K3 on tiles of 0 to 600 pairs, every pixel of the opaque tile
    stopping in the first batch and two pixels stopping on the last pair of
    a batch: against the plain versions, K3 twice bit for bit with K2's
    evaluated pairs, and K6's bands equal to the frame."""
    table, ts, te = _range_table(card)
    gx = RANGE_GRID_X
    fwd = rasterize.composite_fwd(table, ts, te, gx)
    want = rasterize.composite_fwd_plain(table, ts, te, gx)
    for g, w in zip(fwd[:3], want[:3]):
        diff = (g - w).abs()
        assert (diff <= 2e-5).float().mean() >= 0.999
        assert diff.max() <= 5e-3
    assert torch.equal(fwd[3], want[3])
    opaque, stops = len(RANGE_SIZES), len(RANGE_SIZES) + 1
    assert int(fwd[3][opaque].max()) <= 128
    assert int(fwd[3][stops][16 * 5 + 3]) == 128
    assert int(fwd[3][stops][16 * 9 + 12]) == 256
    assert int((fwd[3][stops] == 300).sum()) == 254
    gen = torch.Generator(device=card).manual_seed(2)
    cts = [torch.randn(s, generator=gen, device=card)
           for s in (fwd[0].shape, fwd[1].shape, fwd[2].shape)]
    args = (table, ts, te, gx, *cts, *fwd[:3])
    d1, e1 = rasterize.composite_bwd(*args)
    d2, e2 = rasterize.composite_bwd(*args)
    assert torch.equal(_bits(d1), _bits(d2)) and torch.equal(e1, e2)
    assert torch.equal(e1, fwd[3])
    d_plain, _ = rasterize.composite_bwd_plain(*args)
    assert float(_rows_within(d1, d_plain).min()) >= 0.999
    assert float(d1[:, int(te[-1]):].abs().max()) == 0.0
    for n_bands in (3, 4):
        size = -(-16 // n_bands)
        outs, d_sum = [], torch.zeros_like(table)
        for m in range(n_bands):
            ids, start, end = rasterize.band_slots(ts, te, n_bands, m)
            real = torch.arange(size, device=card) + m * size < 16
            band_cts = [c[..., ids.long(), :] * real[:, None] for c in cts]
            out = rasterize.composite_fwd_bands(table, start, end, gx, ids)
            d_band, e_band = rasterize.composite_bwd_bands(
                table, start, end, gx, ids, *band_cts, *out[:3])
            assert torch.equal(e_band, out[3])
            outs.append(out)
            d_sum = d_sum + d_band
        for k in range(4):
            got = torch.cat([o[k] for o in outs], -2)[..., :16, :]
            assert torch.equal(_bits(got), _bits(fwd[k])), (n_bands, k)
        assert torch.equal(d_sum, d1), n_bands


def _sharded_rank(rank, world, n):
    """One rank of a one-card NCCL group: the sharded step against the
    single-rank step on the same inputs."""
    from priordepth_gaussiansplatting_torch.parallel import integrate, mesh
    from priordepth_gaussiansplatting_torch.parallel import step as pstep
    from priordepth_gaussiansplatting_torch.train import optim, step
    from priordepth_gaussiansplatting_torch.utils import config

    card = torch.device("cuda")
    m = mesh.Mesh(1, 1, device=card)
    assert m.backend == "nccl"
    g = PT.random_gaussians(3, n)
    state = interop_state(g, card)
    cam = PT.look_at_camera((0, 0, -2.5), width=128, height=128, device=card,
                            image=np.random.default_rng(0).random(
                                (3, 128, 128), dtype=np.float32))
    cfgs = (config.OptimizationConfig(),
            config.PipelineConfig(backend="kernels"))
    cap = 1 << 18
    s1, o1, m1 = integrate.make_sharded_fns(*cfgs, m, pair_capacity=cap).step(
        *integrate.place_sharded(state, optim.init_adam(state.params), m),
        pstep.stack_cameras([cam]), 1, None, torch.zeros(3, device=card))
    s2, o2, m2 = step.make_train_step(*cfgs, pair_capacity=cap).step(
        state, optim.init_adam(state.params), cam, 1, None,
        torch.zeros(3, device=card))
    return (float(m1["loss"]), float(m2["loss"]),
            int(m1["skipped"]) + int(m2["skipped"]),
            float((o1.mu.xyz - o2.mu.xyz).abs().max()),
            float(o2.mu.xyz.abs().max()))


def interop_state(g, card):
    from priordepth_gaussiansplatting_torch import interop
    n = g["means"].shape[0]
    params = {
        "xyz": g["means"], "features_dc": g["sh"][:, :3],
        "features_rest": g["sh"][:, 3:], "scaling": np.log(g["scales"]),
        "rotation": g["quats"],
        "opacity": np.log(g["opacities"] / (1 - g["opacities"]))[:, None],
        "exposure": np.eye(3, 4, dtype=np.float32)[None]}
    return interop.gaussian_state_from_numpy(params, np.ones(n, bool), 3, 3,
                                             device=card)


def test_sharded_step_in_a_one_rank_nccl_group(card, tmp_path):
    from priordepth_gaussiansplatting_torch.parallel import mesh
    (loss, loss_single, skipped, diff, scale), = mesh.spawn(
        1, _sharded_rank, 4096, backend="nccl", store_dir=str(tmp_path),
        timeout=120)
    assert skipped == 0 and abs(loss - loss_single) <= 1e-5
    assert diff <= 3e-4 * scale and scale > 0
