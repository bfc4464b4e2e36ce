"""Tile binning: depth sort, pair expansion with cull (K1), tile sort and
the compositor's pair table (K5); the forward half of the JAX package's
``ops/binning.py::bin_sorted_pairs``.

  1. ONE stable sort of the N Gaussians by depth, with empty rects sent to
     the tail (depth inf), so the live prefix has strictly ascending
     exclusive pair offsets.
  2. K1 (``csrc/expand_pairs.cu``): one pair slot per thread, the owning
     Gaussian by binary search over those offsets, the tile from its rect,
     its attribute rows, the exact ellipse-vs-tile cull and a per-tile
     histogram of the kept pairs.
  3. ONE stable sort of the pair slots by tile id (culled and padding slots
     carry ``num_tiles`` and sink past every kept pair), which keeps depth
     order within each tile.
  4. K5 (``csrc/gather_rows.cu``): the tile-sorted, zero-padded
     ``(ATTR_ROWS, v_cap + COMPOSITE_PAD)`` table the compositor reads,
     plus the tile-sorted Gaussian ids.

Pairs beyond ``pair_capacity`` are dropped and counted in
``overflow_rect``; kept pairs beyond ``valid_capacity`` fall outside the
clamped tile ranges and are counted in ``overflow_valid``.

Each kernel wrapper takes its plain PyTorch version for tensors on the CPU
and launches its kernel for tensors on the card; there is no fallback.
"""

from __future__ import annotations

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

def gather_rows_plain(src, gid, perm, v_cap: int, out_len: int):
    """Plain PyTorch version of K5 (see ``csrc/gather_rows.cu``)."""
    head = perm[:v_cap]
    out = torch.zeros(src.shape[0], out_len, dtype=src.dtype,
                      device=src.device)
    out[:, :v_cap] = src[:, head]
    return out, gid[head]


def gather_rows(src, gid, perm, v_cap: int, out_len: int):
    """K5. ``out[:, i] = src[:, perm[i]]`` and ``gid_out[i] = gid[perm[i]]``
    for i < v_cap; columns v_cap..out_len-1 are zero. src (rows, P) f32,
    gid (P,) int32, perm (P,) int64."""
    if src.device.type == "cpu":
        return gather_rows_plain(src, gid, perm, v_cap, out_len)
    kernels.check_cuda("gather_rows", src=src, gid=gid, perm=perm)
    rows, p = src.shape
    if src.dtype != torch.float32 or gid.dtype != torch.int32 \
            or perm.dtype != torch.int64:
        raise TypeError("gather_rows: src f32, gid int32, perm int64")
    if gid.shape != (p,) or perm.shape != (p,) or not v_cap <= min(p, out_len):
        raise ValueError("gather_rows: shapes do not match")
    out = torch.empty(rows, out_len, dtype=torch.float32, device=src.device)
    gid_out = torch.empty(v_cap, dtype=torch.int32, device=src.device)
    ptr, i = kernels.ptr, kernels.i32
    kernels.launch("gather_rows", [ptr] * 3 + [i] * 4 + [ptr] * 2,
                   src, gid, perm, rows, p, v_cap, out_len, out, gid_out)
    return out, gid_out


# --- the forward binning pipeline ----------------------------------------

def depth_sorted_rects(proj: ProjectedGaussians, width: int, height: int,
                       tight: bool = True) -> dict:
    """K1's inputs: the Gaussians sorted by depth (stable; empty rects last,
    at depth inf) with their exclusive pair offsets, rect base tiles, rect
    widths, ids and attribute rows, and the total pair count (1,)."""
    base, nx, counts = _rect_geometry(proj, width, height, tight)
    depth_eff = torch.where(counts > 0, proj.depth,
                            torch.full_like(proj.depth, float("inf")))
    order = torch.sort(depth_eff, stable=True).indices
    incl = torch.cumsum(counts[order], 0)
    return dict(offsets=(incl - counts[order]).to(torch.int32),
                base=base[order].contiguous(), nx=nx[order].contiguous(),
                gid=order.to(torch.int32),
                attrs=pack_attributes(proj)[:, order].contiguous(),
                total=incl[-1:].to(torch.int32))


def bin_sorted_pairs(proj: ProjectedGaussians, width: int, height: int,
                     pair_capacity: int, valid_capacity: int | None = None,
                     tight: bool = True):
    """Bin, depth/tile sort and route the pair attributes in one pass.

    Returns (table, aux): table is the (ATTR_ROWS, valid_capacity +
    COMPOSITE_PAD) tile-sorted pair table; aux holds tile_start / tile_end
    (clamped to valid_capacity), gid_sorted (valid_capacity,), num_valid,
    num_rect, overflow_rect and overflow_valid, as in the JAX package."""
    p = int(pair_capacity)
    v_cap = p if valid_capacity is None else int(valid_capacity)
    if v_cap > p:
        raise ValueError("valid_capacity must not exceed pair_capacity")
    grid_x, grid_y = grid_shape(width, height)
    num_tiles = grid_x * grid_y
    rects = depth_sorted_rects(proj, width, height, tight)
    tile_ids, gidp, pattrs, hist = expand_pairs(
        **rects, p_cap=p, grid_x=grid_x, num_tiles=num_tiles)

    ends = torch.cumsum(hist, 0).to(torch.int32)
    num_valid = ends[-1]
    num_rect = rects["total"][0]
    tile_start = torch.clamp_max(ends - hist, v_cap)
    tile_end = torch.clamp_max(ends, v_cap)

    perm = torch.sort(tile_ids, stable=True).indices
    table, gid_sorted = gather_rows(pattrs, gidp, perm, v_cap,
                                    v_cap + COMPOSITE_PAD)
    aux = dict(
        tile_start=tile_start,
        tile_end=tile_end,
        gid_sorted=gid_sorted,
        num_valid=num_valid,
        num_rect=num_rect,
        overflow_rect=torch.clamp_min(num_rect - p, 0),
        overflow_valid=torch.clamp_min(num_valid - v_cap, 0),
    )
    return table, aux
