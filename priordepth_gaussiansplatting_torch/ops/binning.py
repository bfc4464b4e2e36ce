"""Tile binning: depth sort, pair expansion with cull (K1), tile sort and
the compositor's pair table (K5), and its backward, the sort-back of the
pair gradients (K5b) and their per-Gaussian sum (K4); the JAX package's
``ops/binning.py::bin_sorted_pairs`` with its custom VJP.

  1. ONE stable sort of the N Gaussians by depth, with empty rects sent to
     the tail (depth inf), so the live prefix has strictly ascending
     exclusive pair offsets.
  2. K1 (``csrc/expand_pairs.cu``): one pair slot per thread, 256 a
     block; the block's owning Gaussians found from those offsets (one
     search for its first slot, then the window of
     :func:`owner_window_plain`) and staged once; per slot the tile from
     its owner's rect, its attribute rows, the exact ellipse-vs-tile cull
     and a per-tile histogram of the kept pairs.
  3. ONE stable sort of the pair slots by tile id (culled and padding slots
     carry ``num_tiles`` and sink past every kept pair), which keeps depth
     order within each tile.
  4. K5 (``csrc/gather_rows.cu``): the tile-sorted, zero-padded
     ``(ATTR_ROWS, v_cap + COMPOSITE_PAD)`` table the compositor reads,
     plus the tile-sorted Gaussian ids.

The backward (``_BinSortedPairs``) keys each of the first valid_capacity
table columns by its Gaussian id (n past num_valid), sorts the key
(``torch.sort``, stable; its values are the sorted key K4 reads), gathers
the 10 gradient rows through its permutation (K5b, ``csrc/gather_rows.cu``
again, without the id row) and sums each Gaussian's contiguous segment
(K4, ``csrc/segment_reduce.cu``) in float64, rounded once to f32; K4 finds
the segments in the key itself (:func:`segment_bounds` is the plain form
of its blocks' ranges).

Pairs beyond ``pair_capacity`` are dropped and counted in
``overflow_rect``; kept pairs beyond ``valid_capacity`` fall outside the
clamped tile ranges and are counted in ``overflow_valid``.

:func:`bin_gaussians` is the JAX package's first-round binning (the stage
probe's "bin+sort"): a stable depth argsort, K7 (``expand_tiles``, the
second entry point of ``csrc/expand_pairs.cu``: every pair of each
Gaussian's rect, no attributes and no cull, with the tile histogram;
persistent blocks, each taking its share of the slots in steps of 1,024,
four a thread, with owners staged from a window that skips the zero-count
rects among them; see :func:`window_steps`), the tile ranges from the
histogram, and one stable sort of the (tile, Gaussian) pairs by tile. It
returns a :class:`TileBinning`.

Each kernel wrapper takes its plain PyTorch version for tensors on the CPU
and launches its kernel for tensors on the card; there is no fallback.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from .projection import TILE, ProjectedGaussians, round_bf16, tile_rect, \
    tile_rect_tight

# Pair attribute rows, in the JAX package's ATTR_* order.
ATTR_MX, ATTR_MY = 0, 1
ATTR_CA, ATTR_CB, ATTR_CC = 2, 3, 4
ATTR_OP = 5
ATTR_R, ATTR_G, ATTR_B = 6, 7, 8
ATTR_ID = 9
ATTR_ROWS = 10

# Zero columns past v_cap in the pair table (the JAX table's padding).
COMPOSITE_PAD = 1024

_ALPHA_MIN = 1.0 / 255.0


def grid_shape(width: int, height: int) -> tuple[int, int]:
    return (-(-width // TILE), -(-height // TILE))


def pack_attributes(proj: ProjectedGaussians) -> torch.Tensor:
    """(ATTR_ROWS, N) per-Gaussian attributes; the bf16-valued rows are
    rounded again (a no-op for projection outputs), as the JAX tile sort
    does when it bit-packs them."""
    rows = torch.stack([
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        proj.opacity,
        proj.rgb[:, 0], proj.rgb[:, 1], proj.rgb[:, 2],
        proj.invdepth,
    ])
    return torch.cat([proj.mean2d.T, round_bf16(rows)]).contiguous()


def _rect_geometry(proj: ProjectedGaussians, width: int, height: int,
                   tight: bool):
    """Per Gaussian: first tile of its rect, rect width in tiles, pair
    count (all int32)."""
    grid_x, _ = grid_shape(width, height)
    if tight:
        xmin, ymin, xmax, ymax = tile_rect_tight(proj, width, height)
    else:
        xmin, ymin, xmax, ymax = tile_rect(proj.mean2d, proj.radius, width,
                                           height)
    nx = xmax - xmin
    return ymin * grid_x + xmin, nx, nx * (ymax - ymin)


# --- K1: pair expansion ----------------------------------------------------

def cull_terms(tile, attrs, grid_x):
    """(qmin, limit) of the cull: a pair is kept iff qmin <= limit, i.e. iff
    the peak alpha over the tile's pixel box can reach 1/255. qmin is the
    exact minimum of the conic quadratic over the box (0 inside, else the
    least of the four edges' closed-form minima), limit 2 ln(255 op) with
    1e-3 slack."""
    ty = torch.div(tile, grid_x, rounding_mode="floor")
    tx = tile - ty * grid_x
    mx, my, ca, cb, cc, op = (attrs[r] for r in range(6))
    dxl = (tx * TILE).to(torch.float32) - mx
    dxh = dxl + float(TILE - 1)
    dyl = (ty * TILE).to(torch.float32) - my
    dyh = dyl + float(TILE - 1)
    inside = (dxl <= 0.0) & (dxh >= 0.0) & (dyl <= 0.0) & (dyh >= 0.0)

    def q_at(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    ica = 1.0 / torch.clamp_min(ca, 1e-12)
    icc = 1.0 / torch.clamp_min(cc, 1e-12)
    qx0 = q_at(dxl, torch.clamp(-cb * dxl * icc, dyl, dyh))
    qx1 = q_at(dxh, torch.clamp(-cb * dxh * icc, dyl, dyh))
    qy0 = q_at(torch.clamp(-cb * dyl * ica, dxl, dxh), dyl)
    qy1 = q_at(torch.clamp(-cb * dyh * ica, dxl, dxh), dyh)
    qmin = torch.where(inside, torch.zeros_like(qx0),
                       torch.minimum(torch.minimum(qx0, qx1),
                                     torch.minimum(qy0, qy1)))
    tau = 2.0 * torch.log(torch.clamp_min(op, 1e-12) * (1.0 / _ALPHA_MIN))
    return qmin, tau + 1e-3


# Threads of a warp, and of a K1 or K7 block (K1: one pair slot each); the
# slots of a K7 block's step and the most chunks of EXPAND_BLOCK offsets
# its window reads.
WARP = 32
EXPAND_BLOCK = 256
TILES_STEP = 1024
TILES_CHUNKS = 8


def warp_lower_bound_plain(a, lo: int, hi: int, x: int) -> int:
    """Plain form of the search K1, K4 and K7 run in one warp
    (``csrc/warp_search.cuh``): the first position in ascending ``a[lo,
    hi)`` whose value is >= x (hi if none). Each round tests the 32
    positions lo + l step (step = ceil((hi - lo) / 32)) and keeps the one
    step after the last test below x."""
    while lo < hi:
        step = -(-(hi - lo) // WARP)
        probes = lo + step * torch.arange(WARP, dtype=torch.int64)
        probes = probes[probes < hi]
        c = int((a[probes] < x).sum())
        if c == 0:
            hi = lo
        else:
            lo, hi = lo + (c - 1) * step + 1, min(lo + c * step, hi)
    return lo


def window_steps(total, p_cap: int, slots: int = EXPAND_BLOCK,
                 grid: int | None = None):
    """The slot ranges whose owners a block stages, [p0, last] for each, as
    two int64 tensors: K1's blocks of `slots` from 0 (grid None); or K7's
    persistent blocks (``csrc/expand_pairs.cu``): of `grid` blocks, block b
    takes the whole quads of four slots [Q b / grid, Q (b + 1) / grid) of
    the Q quads below the total and stages them in steps of `slots`."""
    tot = min(int(total.reshape(-1)[0]), p_cap)
    if grid is None:
        p0 = torch.arange(0, max(tot, 0), slots)
        return p0, torch.clamp_max(p0 + slots, tot) - 1
    quads = -(-tot // 4)
    starts, lasts = [], []
    for b in range(grid):
        start, end = 4 * (quads * b // grid), 4 * (quads * (b + 1) // grid)
        for p0 in range(start, end, slots):
            starts.append(p0)
            lasts.append(min(p0 + slots, end, tot) - 1)
    return (torch.tensor(starts, dtype=torch.int64),
            torch.tensor(lasts, dtype=torch.int64))


def owner_window_plain(offsets, total, p_cap: int, slots: int = EXPAND_BLOCK,
                       chunks: int = 1, grid: int | None = None):
    """Plain form of the owner window of K1 and K7 (``csrc/expand_pairs.cu``)
    over ascending offsets (equal runs allowed): for each range of slots a
    block stages (:func:`window_steps`), the owner j0 of its first slot
    (the warp's search for the first offset above it, less one), the count
    of owners it stages (the entries from j0 on that end a run of equal
    offsets and lie at or below its last slot: at most one per slot), and
    whether those reach past `chunks` chunks of :data:`EXPAND_BLOCK`
    entries from j0 (then the block searches each slot's owner in device
    memory). K1: the defaults; K7: :data:`TILES_STEP` slots,
    :data:`TILES_CHUNKS` chunks and its grid (:func:`expand_tiles_grid`).
    Returns three tensors, one entry a range: j0 and count (int64), spill
    (bool)."""
    dev = offsets.device
    off = offsets.long()
    p0, last = (x.to(dev) for x in window_steps(total, p_cap, slots, grid))
    j0 = torch.searchsorted(off, p0, right=True) - 1
    jl = torch.searchsorted(off, last, right=True) - 1  # the last slot's
    ends = torch.ones_like(off)
    ends[:-1] = (off[1:] > off[:-1]).long()
    before = torch.cumsum(ends, 0) - ends  # run ends before each entry
    return (j0, before[jl] - before[j0] + 1,
            jl - j0 >= chunks * EXPAND_BLOCK)


def expand_pairs_plain(offsets, base, nx, gid, attrs, total, p_cap: int,
                       grid_x: int, num_tiles: int):
    """Plain PyTorch version of K1 (see ``csrc/expand_pairs.cu``)."""
    dev = offsets.device
    n = offsets.shape[0]
    pos = torch.arange(p_cap, dtype=torch.int32, device=dev)
    live = pos < torch.clamp_max(total, p_cap)
    j = (torch.searchsorted(offsets, pos, right=True) - 1).clamp(0, n - 1)
    rank = pos - offsets[j]
    w = torch.clamp_min(nx[j], 1)
    q = torch.div(rank, w, rounding_mode="floor")
    tile = base[j] + q * grid_x + (rank - q * w)
    a = attrs[:, j]
    qmin, limit = cull_terms(tile, a, grid_x)
    keep = live & (qmin <= limit)
    tile_out = torch.where(keep, tile, num_tiles).to(torch.int32)
    gid_out = torch.where(live, gid[j], -1).to(torch.int32)
    attrs_out = torch.where(live, a, 0.0)
    hist = torch.bincount(tile_out.long(), minlength=num_tiles + 1)
    return tile_out, gid_out, attrs_out, hist[:num_tiles].to(torch.int32)


def expand_pairs(offsets, base, nx, gid, attrs, total, p_cap: int,
                 grid_x: int, num_tiles: int):
    """K1. Inputs in depth order: exclusive pair offsets, rect base tile,
    rect width and Gaussian id (int32, (N,)), attributes (ATTR_ROWS, N) f32,
    total pairs (1,) int32. Returns, per pair slot, tile id (int32, (p_cap,);
    num_tiles when culled or padding), Gaussian id (int32; -1 for padding),
    attributes (ATTR_ROWS, p_cap) f32; and the kept-pair histogram
    (num_tiles,) int32."""
    if offsets.device.type == "cpu":
        return expand_pairs_plain(offsets, base, nx, gid, attrs, total,
                                  p_cap, grid_x, num_tiles)
    kernels.check_cuda("expand_pairs", offsets=offsets, base=base, nx=nx,
                       gid=gid, attrs=attrs, total=total)
    n = offsets.shape[0]
    for name, t in (("offsets", offsets), ("base", base), ("nx", nx),
                    ("gid", gid), ("total", total)):
        if t.dtype != torch.int32:
            raise TypeError(f"expand_pairs: {name} must be int32")
    if attrs.dtype != torch.float32 or attrs.shape != (ATTR_ROWS, n):
        raise ValueError(f"expand_pairs: attrs must be f32 ({ATTR_ROWS}, {n})")
    dev = offsets.device
    tile_out = torch.empty(p_cap, dtype=torch.int32, device=dev)
    gid_out = torch.empty(p_cap, dtype=torch.int32, device=dev)
    attrs_out = torch.empty(ATTR_ROWS, p_cap, dtype=torch.float32, device=dev)
    hist = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    p, i = kernels.ptr, kernels.i32
    kernels.launch("expand_pairs", [p] * 6 + [i] * 4 + [p] * 4,
                   offsets, base, nx, gid, attrs, total, n, p_cap, grid_x,
                   num_tiles, tile_out, gid_out, attrs_out, hist)
    return tile_out, gid_out, attrs_out, hist


# --- K5: tile-sorted pair table --------------------------------------------

# Rows the gather kernel takes per pass over the columns: few enough that
# the rows being gathered stay in L2 (see csrc/gather_rows.cu).
GATHER_ROWS_PER_PASS = 2


def gather_rows_plain(src, gid, perm, v_cap: int, out_len: int):
    """Plain PyTorch version of K5 (see ``csrc/gather_rows.cu``)."""
    head = perm[:v_cap]
    out = torch.zeros(src.shape[0], out_len, dtype=src.dtype,
                      device=src.device)
    out[:, :v_cap] = src[:, head]
    return out, gid[head]


def _launch_gather_rows(src, gid, perm, v_cap: int, out_len: int,
                        label: str):
    """K5's kernel; `gid` None gathers the table rows alone (K5b)."""
    ids = {} if gid is None else {"gid": gid}
    kernels.check_cuda(label, src=src, perm=perm, **ids)
    if src.dtype != torch.float32 or perm.dtype != torch.int64 \
            or (gid is not None and gid.dtype != torch.int32):
        raise TypeError(f"{label}: src f32, gid int32, perm int64")
    if perm.data_ptr() % 16:
        raise ValueError(f"{label}: perm must start on 16 bytes")
    rows, p = src.shape
    out = torch.empty(rows, out_len, dtype=torch.float32, device=src.device)
    gid_out = None if gid is None else torch.empty(
        v_cap, dtype=torch.int32, device=src.device)
    ptr, i = kernels.ptr, kernels.i32
    kernels.launch("gather_rows", [ptr] * 3 + [i] * 5 + [ptr] * 2,
                   src, gid, perm, rows, p, v_cap, out_len,
                   GATHER_ROWS_PER_PASS, out, gid_out, label=label)
    return out, gid_out


def gather_rows(src, gid, perm, v_cap: int, out_len: int):
    """K5. ``out[:, i] = src[:, perm[i]]`` and ``gid_out[i] = gid[perm[i]]``
    for i < v_cap; columns v_cap..out_len-1 are zero. src (rows, P) f32,
    gid (P,) int32, perm (P,) int64."""
    if src.device.type == "cpu":
        return gather_rows_plain(src, gid, perm, v_cap, out_len)
    p = src.shape[1]
    if gid.shape != (p,) or perm.shape != (p,) or not v_cap <= min(p, out_len):
        raise ValueError("gather_rows: shapes do not match")
    return _launch_gather_rows(src, gid, perm, v_cap, out_len, "gather_rows")


# --- K5b: the sort-back of the pair gradients --------------------------------

def sort_back_rows_plain(d_table, perm):
    """Plain PyTorch version of K5b (see ``csrc/gather_rows.cu``)."""
    return d_table[:, perm]


def sort_back_rows(d_table, perm):
    """K5b. The first v = ``perm.shape[0]`` columns of the tile-sorted
    gradient table moved into Gaussian-id order: ``out[:, i] =
    d_table[:, perm[i]]`` for i < v, where `perm` (v,) int64 is the stable
    sort of the id key (whose values are the sorted key). On the card, K5's
    kernel without the id row, counted as ``gather_rows_bwd``."""
    if d_table.device.type == "cpu":
        return sort_back_rows_plain(d_table, perm)
    v = perm.shape[0]
    if d_table.dim() != 2 or d_table.shape[1] < v:
        raise ValueError("sort_back_rows: shapes do not match")
    return _launch_gather_rows(d_table, None, perm, v, v,
                               "gather_rows_bwd")[0]


# --- K4: per-Gaussian reduction of the id-sorted pair gradients --------------

# K4: key slots a block should span, and the most ids a block owns (its
# shared-memory tile is (ATTR_ROWS, ids) f32).
SEGMENT_SLOTS_PER_BLOCK = 4096
SEGMENT_MAX_IDS = 1024


def segment_ids_per_block(n: int, v: int) -> int:
    """K4's ids per block: the power of two in [32, 1024] at or below
    ``SEGMENT_SLOTS_PER_BLOCK * n / v``, so that a block of the full scene
    (~2.6 key slots per Gaussian) owns 1,024 ids and one of the mid scene
    (~17 per row of its 2^17-row store) 128: on the H100 the fastest of
    the powers of two on both."""
    want = SEGMENT_SLOTS_PER_BLOCK * n // max(v, 1)
    ids = 32
    while ids * 2 <= min(want, SEGMENT_MAX_IDS):
        ids *= 2
    return ids


def segment_bounds(key_sorted, num_valid, n: int, ids_per_block: int = 1):
    """(ceil(n / G) + 1,) int32 with G = `ids_per_block`: the first
    position of the ids 0, G, 2G, ... and of n in the ascending key,
    clipped to num_valid. With G = 1, each Gaussian's segment start; with
    K4's G, the plain form of its blocks' ranges: block b owns the ids [b G,
    b G + G) and reads the columns [bounds[b], bounds[b + 1])."""
    queries = torch.arange(0, n + ids_per_block, ids_per_block,
                           dtype=torch.int32, device=key_sorted.device)
    queries[-1] = n
    bounds = torch.searchsorted(key_sorted, queries, out_int32=True)
    return torch.clamp_max(bounds, num_valid)


def segment_reduce_plain(d_sorted, key_sorted, num_valid, n: int):
    """Plain PyTorch version of K4 (see ``csrc/segment_reduce.cu``): an
    ``index_add_`` over the id in float64, rounded once to f32."""
    rows, v = d_sorted.shape
    pos = torch.arange(v, device=d_sorted.device)
    valid = (pos < num_valid) & (key_sorted < n)
    idx = torch.where(valid, key_sorted, n).long()
    out = torch.zeros(rows, n + 1, dtype=torch.float64,
                      device=d_sorted.device)
    out.index_add_(1, idx, d_sorted.to(torch.float64))
    return out[:, :n].to(torch.float32)


def segment_reduce(d_sorted, key_sorted, num_valid, n: int):
    """K4. Sum per Gaussian of the id-sorted pair rows: d_sorted
    (ATTR_ROWS, v) f32, key_sorted (v,) int32 ascending, num_valid ()
    int32 -> (ATTR_ROWS, n) f32 in original Gaussian order. Positions >=
    num_valid and keys >= n contribute nothing. The kernel sums in float64
    and rounds once, as the plain version does, and finds each block's
    columns in the key itself."""
    if d_sorted.device.type == "cpu":
        return segment_reduce_plain(d_sorted, key_sorted, num_valid, n)
    kernels.check_cuda("segment_reduce", d_sorted=d_sorted,
                       key_sorted=key_sorted, num_valid=num_valid)
    rows, v = d_sorted.shape
    if d_sorted.dtype != torch.float32 or rows != ATTR_ROWS:
        raise ValueError(f"segment_reduce: d_sorted must be f32 "
                         f"({ATTR_ROWS}, v)")
    if key_sorted.dtype != torch.int32 or key_sorted.shape != (v,):
        raise ValueError("segment_reduce: key_sorted must be int32 (v,)")
    if num_valid.dtype != torch.int32 or num_valid.numel() != 1:
        raise ValueError("segment_reduce: num_valid must be one int32")
    # 16-byte loads need every row and the key to start on 16 bytes.
    vec = (v % 4 == 0 and d_sorted.data_ptr() % 16 == 0
           and key_sorted.data_ptr() % 16 == 0)
    out = torch.empty(rows, n, dtype=torch.float32, device=d_sorted.device)
    p, i = kernels.ptr, kernels.i32
    kernels.launch("segment_reduce", [p, p, i, p, i, i, i, p], d_sorted,
                   key_sorted, v, num_valid, n,
                   segment_ids_per_block(n, v), int(vec), out)
    return out


def pair_grads_to_gaussians(d_table, gid_sorted, num_valid, n: int):
    """The binning's backward: the tile-sorted pair gradients (ATTR_ROWS,
    L) summed per Gaussian into (ATTR_ROWS, n), original order. The key is
    the tile-sorted Gaussian id where position < num_valid, else n; a stable
    sort of it (its values are the sorted key), K5b through its
    permutation, then K4."""
    v = gid_sorted.shape[0]
    pos = torch.arange(v, device=gid_sorted.device)
    key = torch.where(pos < num_valid, gid_sorted, n).to(torch.int32)
    key_sorted, perm = torch.sort(key, stable=True)
    d_sorted = sort_back_rows(d_table.contiguous(), perm)
    return segment_reduce(d_sorted, key_sorted, num_valid, n)


# --- the forward binning pipeline ----------------------------------------

def _rect_inputs(proj: ProjectedGaussians, width: int, height: int,
                 tight: bool):
    """Per Gaussian, original order: rect base tile, rect width, pair count
    and the sort depth (inf for an empty rect)."""
    base, nx, counts = _rect_geometry(proj, width, height, tight)
    depth_eff = torch.where(counts > 0, proj.depth,
                            torch.full_like(proj.depth, float("inf")))
    return base, nx, counts, depth_eff


def _depth_sort(attrs10, depth_eff, base, nx, counts) -> dict:
    order = torch.sort(depth_eff, stable=True).indices
    incl = torch.cumsum(counts[order], 0)
    return dict(offsets=(incl - counts[order]).to(torch.int32),
                base=base[order].contiguous(), nx=nx[order].contiguous(),
                gid=order.to(torch.int32),
                attrs=attrs10[:, order].contiguous(),
                total=incl[-1:].to(torch.int32))


def depth_sorted_rects(proj: ProjectedGaussians, width: int, height: int,
                       tight: bool = True) -> dict:
    """K1's inputs: the Gaussians sorted by depth (stable; empty rects last,
    at depth inf) with their exclusive pair offsets, rect base tiles, rect
    widths, ids and attribute rows, and the total pair count (1,)."""
    base, nx, counts, depth_eff = _rect_inputs(proj, width, height, tight)
    return _depth_sort(pack_attributes(proj), depth_eff, base, nx, counts)


AUX_KEYS = ("tile_start", "tile_end", "gid_sorted", "num_valid", "num_rect",
            "overflow_rect", "overflow_valid")


class _BinSortedPairs(torch.autograd.Function):
    """Forward: depth sort, K1, tile sort, K5 -> (table, *aux). Backward:
    the pair gradients back to the (ATTR_ROWS, N) attribute rows by
    :func:`pair_grads_to_gaussians`; the sort depth gets a zero gradient."""

    @staticmethod
    def forward(ctx, attrs10, depth_eff, base, nx, counts, spec):
        grid_x, num_tiles, p, v_cap = spec
        rects = _depth_sort(attrs10, depth_eff, base, nx, counts)
        tile_ids, gidp, pattrs, hist = expand_pairs(
            **rects, p_cap=p, grid_x=grid_x, num_tiles=num_tiles)
        ends = torch.cumsum(hist, 0).to(torch.int32)
        num_valid = ends[-1]
        num_rect = rects["total"][0]
        perm = torch.sort(tile_ids, stable=True).indices
        table, gid_sorted = gather_rows(pattrs, gidp, perm, v_cap,
                                        v_cap + COMPOSITE_PAD)
        aux = (torch.clamp_max(ends - hist, v_cap),
               torch.clamp_max(ends, v_cap), gid_sorted, num_valid, num_rect,
               torch.clamp_min(num_rect - p, 0),
               torch.clamp_min(num_valid - v_cap, 0))
        ctx.mark_non_differentiable(*aux)
        ctx.save_for_backward(gid_sorted, num_valid)
        ctx.n = attrs10.shape[1]
        return (table,) + aux

    @staticmethod
    def backward(ctx, d_table, *_):
        gid_sorted, num_valid = ctx.saved_tensors
        d_attrs = pair_grads_to_gaussians(d_table, gid_sorted, num_valid,
                                          ctx.n)
        return d_attrs, None, None, None, None, None


def bin_sorted_pairs(proj: ProjectedGaussians, width: int, height: int,
                     pair_capacity: int, valid_capacity: int | None = None,
                     tight: bool = True):
    """Bin, depth/tile sort and route the pair attributes in one pass.

    Returns (table, aux): table is the (ATTR_ROWS, valid_capacity +
    COMPOSITE_PAD) tile-sorted pair table; aux holds tile_start / tile_end
    (clamped to valid_capacity), gid_sorted (valid_capacity,), num_valid,
    num_rect, overflow_rect and overflow_valid, as in the JAX package.
    The table is differentiable with respect to ``pack_attributes(proj)``
    (so to mean2d, conic, opacity, rgb and inverse depth); its backward
    runs K5b and K4."""
    p = int(pair_capacity)
    v_cap = p if valid_capacity is None else int(valid_capacity)
    if v_cap > p:
        raise ValueError("valid_capacity must not exceed pair_capacity")
    grid_x, grid_y = grid_shape(width, height)
    base, nx, counts, depth_eff = _rect_inputs(proj, width, height, tight)
    table, *aux = _BinSortedPairs.apply(
        pack_attributes(proj), depth_eff, base, nx, counts,
        (grid_x, grid_x * grid_y, p, v_cap))
    return table, dict(zip(AUX_KEYS, aux))


# --- K7 and the first-round binning ------------------------------------------

# bin_gaussians' pair capacity is a multiple of this (the JAX kernel's chunk).
EXP_K = 1024


@dataclasses.dataclass
class TileBinning:
    """Depth-ordered (Gaussian, tile) pairs sorted by tile, with per-tile
    ranges; the JAX package's ``TileBinning``. ``gauss_ids`` are original
    Gaussian indices; slots past ``num_pairs`` are padding (tile
    ``num_tiles``, id -1)."""

    depth_order: torch.Tensor  # (N,) int32, front-to-back Gaussian order
    gauss_ids: torch.Tensor    # (P,) int32, original Gaussian per pair
    tile_ids: torch.Tensor     # (P,) int32, tile per pair, ascending
    tile_start: torch.Tensor   # (num_tiles,) int32
    tile_end: torch.Tensor     # (num_tiles,) int32
    num_pairs: torch.Tensor    # () int32, live pairs (<= P)
    overflow: torch.Tensor     # () int32, pairs dropped for capacity


def expand_tiles_plain(offsets, base, nx, gid, total, p_cap: int,
                       grid_x: int, num_tiles: int):
    """Plain PyTorch version of K7 (see ``csrc/expand_pairs.cu``)."""
    dev = offsets.device
    n = offsets.shape[0]
    pos = torch.arange(p_cap, dtype=torch.int32, device=dev)
    live = pos < torch.clamp_max(total, p_cap)
    j = (torch.searchsorted(offsets, pos, right=True) - 1).clamp(0, n - 1)
    rank = pos - offsets[j]
    w = torch.clamp_min(nx[j], 1)
    q = torch.div(rank, w, rounding_mode="floor")
    tile = base[j] + q * grid_x + (rank - q * w)
    tile_out = torch.where(live, tile, num_tiles).to(torch.int32)
    gid_out = torch.where(live, gid[j], -1).to(torch.int32)
    hist = torch.bincount(tile_out.long(), minlength=num_tiles + 1)
    return tile_out, gid_out, hist[:num_tiles].to(torch.int32)


def expand_tiles(offsets, base, nx, gid, total, p_cap: int, grid_x: int,
                 num_tiles: int):
    """K7. Inputs in depth order, zero-count rects included: exclusive pair
    offsets (ascending, clamped to p_cap), rect base tile, rect width and
    Gaussian id (int32, (N,)); total pairs (1,) int32. Returns, per pair
    slot, tile id (int32, (p_cap,); num_tiles past the total) and Gaussian
    id (-1 past the total), and the per-tile pair histogram (num_tiles,)
    int32, a view of the launch's buffer. One launch, no memset."""
    if offsets.device.type == "cpu":
        return expand_tiles_plain(offsets, base, nx, gid, total, p_cap,
                                  grid_x, num_tiles)
    kernels.check_cuda("expand_tiles", offsets=offsets, base=base, nx=nx,
                       gid=gid, total=total)
    for name, t in (("offsets", offsets), ("base", base), ("nx", nx),
                    ("gid", gid), ("total", total)):
        if t.dtype != torch.int32:
            raise TypeError(f"expand_tiles: {name} must be int32")
    dev = offsets.device
    tile_out = torch.empty(p_cap, dtype=torch.int32, device=dev)
    gid_out = torch.empty(p_cap, dtype=torch.int32, device=dev)
    # No memset: the kernel zeroes the histogram, and the two words after
    # it (from an even index) carry its launch's flag.
    hist = torch.empty(num_tiles + num_tiles % 2 + 2, dtype=torch.int32,
                       device=dev)
    p, i = kernels.ptr, kernels.i32
    kernels.launch("expand_pairs", [p] * 5 + [i] * 4 + [p] * 3,
                   offsets, base, nx, gid, total, offsets.shape[0], p_cap,
                   grid_x, num_tiles, tile_out, gid_out, hist,
                   entry="expand_tiles")
    return tile_out, gid_out, hist[:num_tiles]


def expand_tiles_grid(p_cap: int, num_tiles: int) -> dict:
    """K7's launch on the current card for `p_cap` slots over `num_tiles`
    tiles: blocks per SM, its grid of persistent blocks, the bytes of its
    shared histogram and whether it keeps one (else its atomics go to the
    histogram in device memory)."""
    import ctypes
    out = (ctypes.c_int * 4)()
    rc = kernels.build.entry("expand_pairs", "expand_tiles_shape",
                             [kernels.i32, kernels.i32,
                              ctypes.POINTER(ctypes.c_int)])(p_cap, num_tiles,
                                                             out)
    if rc != 0:
        raise RuntimeError(f"expand_tiles_shape failed ({rc})")
    return dict(blocks_per_sm=out[0], grid=out[1], shared_hist_bytes=out[2],
                shared_hist=bool(out[3]))


def tile_inputs(proj: ProjectedGaussians, width: int, height: int,
                pair_capacity: int) -> dict:
    """K7's inputs: every Gaussian in stable depth order (``depth_order``,
    int32) with its exclusive pair offset (clamped to the capacity), rect
    base tile, rect width (the loose ``tile_rect``) and id, and the total
    pair count: ``total`` (1,) int32 clamped to the capacity and
    ``total_all`` () int64."""
    order = torch.sort(proj.depth, stable=True).indices
    base, nx, counts = _rect_geometry(proj, width, height, tight=False)
    counts = counts[order].to(torch.int64)
    incl = torch.cumsum(counts, 0)
    total_all = incl[-1] if incl.numel() else incl.new_zeros(())
    offsets = torch.clamp_max(incl - counts, pair_capacity)
    return dict(offsets=offsets.to(torch.int32),
                base=base[order].to(torch.int32).contiguous(),
                nx=nx[order].to(torch.int32).contiguous(),
                gid=order.to(torch.int32),
                total=torch.clamp_max(total_all, pair_capacity).to(
                    torch.int32).reshape(1),
                total_all=total_all)


def bin_gaussians(proj: ProjectedGaussians, width: int, height: int,
                  pair_capacity: int) -> TileBinning:
    """The JAX package's ``bin_gaussians``: depth order, K7, per-tile
    ranges from its histogram, and one stable sort of the pairs by tile
    (depth order within each tile). `pair_capacity` is a multiple of
    :data:`EXP_K`."""
    p = int(pair_capacity)
    if p % EXP_K:
        raise ValueError(f"pair_capacity must be a multiple of {EXP_K}")
    grid_x, grid_y = grid_shape(width, height)
    num_tiles = grid_x * grid_y
    x = tile_inputs(proj, width, height, p)
    tile_ids, gid, hist = expand_tiles(
        x["offsets"], x["base"], x["nx"], x["gid"], x["total"], p, grid_x,
        num_tiles)
    ends = torch.cumsum(hist, 0).to(torch.int32)
    perm = torch.sort(tile_ids, stable=True).indices
    return TileBinning(
        depth_order=x["gid"], gauss_ids=gid[perm], tile_ids=tile_ids[perm],
        tile_start=ends - hist, tile_end=ends, num_pairs=x["total"][0],
        overflow=torch.clamp_min(x["total_all"] - p, 0).to(torch.int32))
