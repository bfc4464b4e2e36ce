"""The tile rasterizer: binning (K1, K5) then the tile compositor (K2),
differentiable through the compositor's backward (K3) and the binning's
(K5b, K4); counterpart of the JAX package's
``ops/rasterize_pallas.py::rasterize``, ``_fwd_kernel`` and ``_bwd_kernel``.
K6 (:func:`composite_bands`, the JAX package's ``composite_bands``) is the
same compositor over one band of the tile grid, for the tile-sharded
multi-rank step: each slot has its own pair range, so pad slots composite
nothing and get no gradient.

Compositing semantics are the oracle's (``ops/reference.py``): alpha =
min(0.99, op e^power), skipped if power > 0 or alpha < 1/255; the walk stops
before the pair that would take T below 1e-4. The background is added after
the kernel. Gradients follow the JAX kernel's: none through the 0.99 clamp,
the skips or the stop.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from . import binning
from .projection import TILE, ProjectedGaussians

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
PIX = TILE * TILE


def _composite_tile_plain(pairs, tile: int, grid_x: int):
    """One tile against its (ATTR_ROWS, K) pairs, with the oracle's
    prefix-product formulation: colour (3, PIX), inverse depth, final T and
    pairs evaluated per pixel (PIX,)."""
    ty, tx = divmod(tile, grid_x)
    pix = torch.arange(PIX, device=pairs.device)
    px = (tx * TILE + pix % TILE).to(torch.float32)[:, None]
    py = (ty * TILE + pix // TILE).to(torch.float32)[:, None]
    dx = px - pairs[binning.ATTR_MX]
    dy = py - pairs[binning.ATTR_MY]
    power = (-0.5 * (pairs[binning.ATTR_CA] * dx * dx
                     + pairs[binning.ATTR_CC] * dy * dy)
             - pairs[binning.ATTR_CB] * dx * dy)
    alpha = torch.clamp_max(pairs[binning.ATTR_OP] * torch.exp(power),
                            ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(keep, alpha, torch.zeros_like(alpha))
    cum = torch.cumprod(1.0 - a, dim=1)
    live = cum >= T_EPS
    t_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    w = torch.where(live, a * t_excl, torch.zeros_like(a))
    color = (w[None] * pairs[binning.ATTR_R:binning.ATTR_B + 1, None, :]).sum(-1)
    invd = (w * pairs[binning.ATTR_ID]).sum(-1)
    final_t = torch.where(live, 1.0 - a, torch.ones_like(a)).prod(-1)
    k = pairs.shape[1]
    dead = ~live
    n_eval = torch.where(dead.any(1), dead.to(torch.int32).argmax(1) + 1, k)
    return color, invd, final_t, n_eval.to(torch.int32)


def composite_fwd_bands_plain(table, band_start, band_end, grid_x: int,
                              tile_ids):
    """Plain PyTorch version of K6's forward (and of K2, which it serves):
    slot b composites tile ``tile_ids[b]`` over ``[band_start[b],
    band_end[b])``; a loop over slots, vectorised over pixels and pairs
    within a tile."""
    dev = table.device
    n = tile_ids.shape[0]
    color = torch.zeros(3, n, PIX, device=dev)
    invd = torch.zeros(n, PIX, device=dev)
    final_t = torch.ones(n, PIX, device=dev)
    n_eval = torch.zeros(n, PIX, dtype=torch.int32, device=dev)
    for b, (t, s, e) in enumerate(zip(tile_ids.tolist(), band_start.tolist(),
                                      band_end.tolist())):
        if e > s:
            color[:, b], invd[b], final_t[b], n_eval[b] = \
                _composite_tile_plain(table[:, s:e], t, grid_x)
    return color, invd, final_t, n_eval


def _edge_min(a, b, c, det, x0, x1, y):
    """``edge_min`` of ``csrc/composite_eval.cuh`` in the same f32
    operations: a lower bound of a x^2 + 2 b x y + c y^2 over x in [x0, x1]."""
    cyy = c * y * y
    m = torch.minimum(a * x0 * x0 + 2.0 * b * x0 * y + cyy,
                      a * x1 * x1 + 2.0 * b * x1 * y + cyy)
    xs = -b * y / a
    slack = 1e-3 * (1.0 + x0.abs() + x1.abs())
    inner = (xs >= x0 - slack) & (xs <= x1 + slack)
    return torch.where(inner, torch.minimum(m, y * y * det / a), m)


def walking_warps_plain(table, tile_start, tile_end, grid_x: int):
    """Which of the four warps of K2's and K3's block walk each pair: bit w
    of entry k is set when a pixel of warp w's 8x8 quarter of pair k's tile
    may keep pair k (``keeping_warps`` of ``csrc/composite_eval.cuh``, in
    the same f32 operations). (L,) int32, 0 outside the tiles' ranges."""
    dev = table.device
    counts = (tile_end - tile_start).clamp_min(0).long()
    tiles = torch.repeat_interleave(torch.arange(counts.shape[0],
                                                 device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    cols = (torch.repeat_interleave(tile_start.long(), counts)
            + torch.arange(tiles.shape[0], device=dev)
            - torch.repeat_interleave(first, counts))
    mx, my, a, b, c, op = table[:6, cols]
    thr = torch.log(ALPHA_MIN / op) - 1e-3
    tile_x0 = (tiles % grid_x * TILE).to(torch.float32)
    tile_y0 = (tiles // grid_x * TILE).to(torch.float32)
    ac = a * c
    det = ac - b * b
    limit = -2.06 * thr
    walks = torch.zeros_like(tiles, dtype=torch.int32)
    for w in range(4):
        left = tile_x0 + float(8 * (w & 1))
        top = tile_y0 + float(8 * (w >> 1))
        x0, x1 = left - mx, (left + 7.0) - mx
        y0, y1 = top - my, (top + 7.0) - my
        inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)
        low = torch.minimum(
            torch.minimum(_edge_min(a, b, c, det, x0, x1, y0),
                          _edge_min(a, b, c, det, x0, x1, y1)),
            torch.minimum(_edge_min(c, b, a, det, y0, y1, x0),
                          _edge_min(c, b, a, det, y0, y1, x1)))
        walks |= (inside | (low <= limit)).to(torch.int32) << w
    finite = ((mx.abs() < 1e8) & (my.abs() < 1e8) & (a < 1e12)
              & (b.abs() < 1e12) & (c < 1e12) & (a > 0) & (c > 0))
    walks = torch.where(finite & (thr < 0) & (det >= 0.01 * ac), walks, 15)
    walks = torch.where(finite & (thr >= 0), 0, walks)
    out = torch.zeros(table.shape[1], dtype=torch.int32, device=dev)
    out[cols] = walks
    return out


def _all_tiles(tile_start, tiles):
    if tiles is None:
        return torch.arange(tile_start.shape[0], dtype=torch.int32,
                            device=tile_start.device)
    return tiles


def composite_fwd_plain(table, tile_start, tile_end, grid_x: int,
                        tiles=None):
    """Plain PyTorch version of K2 (see ``csrc/composite_fwd.cu``)."""
    tiles = _all_tiles(tile_start, tiles)
    return composite_fwd_bands_plain(table, tile_start[tiles],
                                     tile_end[tiles], grid_x, tiles)


def _launch_fwd(entry: str, table, starts, ends, grid_x: int, tiles, n: int):
    """Check the arguments of K2 or K6 and launch it: colour (3, n, PIX),
    inverse depth, final T (n, PIX) f32 and pairs evaluated (n, PIX)."""
    args = dict(table=table, starts=starts, ends=ends)
    if tiles is not None:
        args["tiles"] = tiles
    kernels.check_cuda(entry, **args)
    if table.dtype != torch.float32 or table.shape[0] != binning.ATTR_ROWS:
        raise ValueError(f"{entry}: table must be f32 (ATTR_ROWS, L)")
    if any(t.dtype != torch.int32 for k, t in args.items() if k != "table"):
        raise TypeError(f"{entry}: tile ranges and ids must be int32")
    dev = table.device
    color = torch.empty(3, n, PIX, device=dev)
    invd = torch.empty(n, PIX, device=dev)
    final_t = torch.empty(n, PIX, device=dev)
    n_eval = torch.empty(n, PIX, dtype=torch.int32, device=dev)
    p, i = kernels.ptr, kernels.i32
    kernels.launch("composite_fwd", [p, i, p, p, p, i, i, p, p, p, p],
                   table, table.shape[1], starts, ends, tiles, n, grid_x,
                   color, invd, final_t, n_eval, entry=entry)
    return color, invd, final_t, n_eval


def composite_fwd(table, tile_start, tile_end, grid_x: int, tiles=None):
    """K2. Composites the listed tiles (all tiles when `tiles` is None) of
    the (ATTR_ROWS, L) tile-sorted pair table over their ranges
    [tile_start[t], tile_end[t]). Returns colour (3, n, PIX), inverse depth
    (n, PIX), final T (n, PIX) f32 and pairs evaluated per pixel (n, PIX)
    int32, with pixel index 16 * row + column inside the tile."""
    if table.device.type == "cpu":
        return composite_fwd_plain(table, tile_start, tile_end, grid_x, tiles)
    n = tile_start.shape[0] if tiles is None else tiles.shape[0]
    return _launch_fwd("composite_fwd", table, tile_start, tile_end, grid_x,
                       tiles, n)


def composite_fwd_bands(table, band_start, band_end, grid_x: int, tile_ids):
    """K6's forward: K2 over one band's slots, slot b being global tile
    ``tile_ids[b]`` with its own range ``[band_start[b], band_end[b])``
    (empty for a pad slot). Outputs as K2's, one row per slot."""
    if table.device.type == "cpu":
        return composite_fwd_bands_plain(table, band_start, band_end, grid_x,
                                         tile_ids)
    n = tile_ids.shape[0]
    if band_start.shape != (n,) or band_end.shape != (n,):
        raise ValueError(f"composite_fwd_bands: ranges must be ({n},)")
    return _launch_fwd("composite_fwd_bands", table, band_start, band_end,
                       grid_x, tile_ids, n)


def _composite_tile_bwd_plain(pairs, tile: int, grid_x: int, d_color, d_invd,
                              d_final_t, color, invd, final_t):
    """One tile's per-pair gradient rows (ATTR_ROWS, K) and pairs evaluated
    per pixel, in the JAX kernel's forward-sweep formulation (see
    ``csrc/composite_bwd.cu``). Pixel fields are (PIX,), colour ones
    (3, PIX)."""
    b = binning
    ty, tx = divmod(tile, grid_x)
    pix = torch.arange(PIX, device=pairs.device)
    px = (tx * TILE + pix % TILE).to(torch.float32)[:, None]
    py = (ty * TILE + pix // TILE).to(torch.float32)[:, None]
    ca, cb, cc = pairs[b.ATTR_CA], pairs[b.ATTR_CB], pairs[b.ATTR_CC]
    dx = px - pairs[b.ATTR_MX]
    dy = py - pairs[b.ATTR_MY]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    g = torch.exp(power)
    raw = pairs[b.ATTR_OP] * g
    alpha = torch.clamp_max(raw, ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(keep, alpha, torch.zeros_like(alpha))
    cum = torch.cumprod(1.0 - a, dim=1)
    live = cum >= T_EPS
    t_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
    w = torch.where(live, a * t_excl, torch.zeros_like(a))
    rgb = pairs[b.ATTR_R:b.ATTR_B + 1]
    rho = (d_color[0, :, None] * rgb[0] + d_color[1, :, None] * rgb[1]
           + d_color[2, :, None] * rgb[2] + d_invd[:, None] * pairs[b.ATTR_ID])
    r_total = (d_color[0] * color[0] + d_color[1] * color[1]
               + d_color[2] * color[2] + d_invd * invd)
    suffix = r_total[:, None] - torch.cumsum(w * rho, dim=1)
    used = live & keep
    g_alpha = t_excl * rho - (suffix + (d_final_t * final_t)[:, None]) / (1.0 - a)
    g_alpha = torch.where(used & (raw < ALPHA_MAX), g_alpha,
                          torch.zeros_like(g_alpha))
    d_power = a * g_alpha
    zero = torch.zeros_like(g_alpha)
    rows = [d_power * (ca * dx + cb * dy), d_power * (cc * dy + cb * dx),
            -0.5 * d_power * dx * dx, -d_power * dx * dy,
            -0.5 * d_power * dy * dy, torch.where(used, g * g_alpha, zero),
            w * d_color[0, :, None], w * d_color[1, :, None],
            w * d_color[2, :, None], w * d_invd[:, None]]
    k = pairs.shape[1]
    dead = ~live
    n_eval = torch.where(dead.any(1), dead.to(torch.int32).argmax(1) + 1, k)
    return torch.stack([r.sum(0) for r in rows]), n_eval.to(torch.int32)


def composite_bwd_bands_plain(table, band_start, band_end, grid_x: int,
                              tile_ids, d_color, d_invd, d_final_t, color,
                              invd, final_t):
    """Plain PyTorch version of K6's backward (and of K3, which it serves):
    a loop over slots, vectorised over pixels and pairs within a tile;
    columns outside the slots' ranges stay zero."""
    d_table = torch.zeros_like(table)
    n_eval = torch.zeros(tile_ids.shape[0], PIX, dtype=torch.int32,
                         device=table.device)
    for i, (t, s, e) in enumerate(zip(tile_ids.tolist(), band_start.tolist(),
                                      band_end.tolist())):
        if e > s:
            d_table[:, s:e], n_eval[i] = _composite_tile_bwd_plain(
                table[:, s:e], t, grid_x, d_color[:, i], d_invd[i],
                d_final_t[i], color[:, i], invd[i], final_t[i])
    return d_table, n_eval


def composite_bwd_plain(table, tile_start, tile_end, grid_x: int, d_color,
                        d_invd, d_final_t, color, invd, final_t, tiles=None):
    """Plain PyTorch version of K3 (see ``csrc/composite_bwd.cu``)."""
    tiles = _all_tiles(tile_start, tiles)
    return composite_bwd_bands_plain(table, tile_start[tiles],
                                     tile_end[tiles], grid_x, tiles, d_color,
                                     d_invd, d_final_t, color, invd, final_t)


def _launch_bwd(entry: str, table, starts, ends, grid_x: int, tiles, n: int,
                d_color, d_invd, d_final_t, color, invd, final_t):
    """Check the arguments of K3 or K6's backward and launch it: the
    (ATTR_ROWS, L) gradient table, zero outside the evaluated pairs, and
    the pairs evaluated (n, PIX) int32."""
    pixel = dict(d_invd=d_invd, d_final_t=d_final_t, invd=invd,
                 final_t=final_t)
    args = dict(table=table, starts=starts, ends=ends, d_color=d_color,
                color=color, **pixel)
    if tiles is not None:
        args["tiles"] = tiles
    kernels.check_cuda(entry, **args)
    if table.dtype != torch.float32 or table.shape[0] != binning.ATTR_ROWS:
        raise ValueError(f"{entry}: table must be f32 (ATTR_ROWS, L)")
    if any(t.dtype != torch.int32 for k, t in args.items()
           if k in ("starts", "ends", "tiles")):
        raise TypeError(f"{entry}: tile ranges and ids must be int32")
    for k, t in dict(d_color=d_color, color=color).items():
        if t.dtype != torch.float32 or t.shape != (3, n, PIX):
            raise ValueError(f"{entry}: {k} must be f32 (3, {n}, {PIX})")
    for k, t in pixel.items():
        if t.dtype != torch.float32 or t.shape != (n, PIX):
            raise ValueError(f"{entry}: {k} must be f32 ({n}, {PIX})")
    d_table = torch.zeros_like(table)
    n_eval = torch.empty(n, PIX, dtype=torch.int32, device=table.device)
    p, i = kernels.ptr, kernels.i32
    kernels.launch("composite_bwd", [p, i, p, p, p, i, i] + [p] * 8,
                   table, table.shape[1], starts, ends, tiles, n, grid_x,
                   d_color, d_invd, d_final_t, color, invd, final_t, d_table,
                   n_eval, entry=entry)
    return d_table, n_eval


def composite_bwd(table, tile_start, tile_end, grid_x: int, d_color, d_invd,
                  d_final_t, color, invd, final_t, tiles=None):
    """K3. The backward of :func:`composite_fwd` over the same tiles: from
    the cotangents of colour (3, n, PIX), inverse depth and final T (n,
    PIX) and the forward's outputs, the (ATTR_ROWS, L) per-pair gradient
    table (zero outside the evaluated pairs) and the pairs each pixel
    evaluated (n, PIX) int32, which equal K2's count."""
    if table.device.type == "cpu":
        return composite_bwd_plain(table, tile_start, tile_end, grid_x,
                                   d_color, d_invd, d_final_t, color, invd,
                                   final_t, tiles)
    n = tile_start.shape[0] if tiles is None else tiles.shape[0]
    return _launch_bwd("composite_bwd", table, tile_start, tile_end, grid_x,
                       tiles, n, d_color, d_invd, d_final_t, color, invd,
                       final_t)


def composite_bwd_bands(table, band_start, band_end, grid_x: int, tile_ids,
                        d_color, d_invd, d_final_t, color, invd, final_t):
    """K6's backward: K3 over one band's slots (see
    :func:`composite_fwd_bands`). The gradient table is zero in every column
    outside the band's ranges, so the bands' tables sum to the frame's."""
    if table.device.type == "cpu":
        return composite_bwd_bands_plain(table, band_start, band_end, grid_x,
                                         tile_ids, d_color, d_invd, d_final_t,
                                         color, invd, final_t)
    n = tile_ids.shape[0]
    if band_start.shape != (n,) or band_end.shape != (n,):
        raise ValueError(f"composite_bwd_bands: ranges must be ({n},)")
    return _launch_bwd("composite_bwd_bands", table, band_start, band_end,
                       grid_x, tile_ids, n, d_color, d_invd, d_final_t, color,
                       invd, final_t)


class _Composite(torch.autograd.Function):
    """K2 forward and K3 backward, or with `bands` K6's two; the custom VJP
    of the JAX package's ``_make_composite``. Saves the table, the ranges
    and the forward's colour, inverse depth and final T; the pair counts
    are not differentiable."""

    @staticmethod
    def forward(ctx, table, starts, ends, grid_x, tiles, bands):
        fwd = composite_fwd_bands if bands else composite_fwd
        color, invd, final_t, n_eval = fwd(table, starts, ends, grid_x, tiles)
        extra = () if tiles is None else (tiles,)
        ctx.save_for_backward(table, starts, ends, color, invd, final_t,
                              *extra)
        ctx.grid_x, ctx.bands = grid_x, bands
        ctx.mark_non_differentiable(n_eval)
        return color, invd, final_t, n_eval

    @staticmethod
    def backward(ctx, d_color, d_invd, d_final_t, _):
        table, starts, ends, color, invd, final_t, *extra = ctx.saved_tensors
        tiles = extra[0] if extra else None
        cts = (d_color.contiguous(), d_invd.contiguous(),
               d_final_t.contiguous(), color, invd, final_t)
        if ctx.bands:
            d_table, _ = composite_bwd_bands(table, starts, ends, ctx.grid_x,
                                             tiles, *cts)
        else:
            d_table, _ = composite_bwd(table, starts, ends, ctx.grid_x, *cts,
                                       tiles=tiles)
        return d_table, None, None, None, None, None


def composite(table, tile_start, tile_end, grid_x: int, tiles=None):
    """Differentiable :func:`composite_fwd` (gradient with respect to the
    table, by K3)."""
    return _Composite.apply(table, tile_start, tile_end, grid_x, tiles, False)


def band_slots(tile_start, tile_end, n_bands: int, band: int):
    """Band `band` of `n_bands` over the tile grid, cut as the JAX
    package's ``parallel/step.py::_rasterize_tile_sharded`` cuts it:
    ceil(num_tiles / n_bands) slots of consecutive global tile ids with
    their pair ranges; the pad slots past the last tile hold tile 0 with the
    empty range [0, 0). Returns (tile_ids, band_start, band_end), int32."""
    nt = tile_start.shape[0]
    size = -(-nt // n_bands)
    ids = torch.arange(band * size, (band + 1) * size, dtype=torch.int32,
                       device=tile_start.device)
    real = ids < nt
    ids = torch.where(real, ids, torch.zeros_like(ids))
    zero = torch.zeros_like(ids)
    return (ids, torch.where(real, tile_start[ids], zero),
            torch.where(real, tile_end[ids], zero))


def composite_bands(table, tile_ids, band_start, band_end, width: int,
                    height: int):
    """K6: the differentiable compositor over one band (see
    :func:`band_slots`). Returns the raw tiles colour (3, n, PIX), inverse
    depth and final T (1, n, PIX); gather the bands along dim 1 and
    assemble with :func:`tiles_to_image`. The table's gradient is zero
    outside the band's pairs."""
    grid_x, _ = binning.grid_shape(width, height)
    color, invd, final_t, _ = _Composite.apply(table, band_start, band_end,
                                               grid_x, tile_ids, True)
    return color, invd[None], final_t[None]


def tiles_to_image(tiles: torch.Tensor, width: int, height: int):
    """(C, num_tiles, PIX) -> (C, H, W), cropping the grid's padding."""
    grid_x, grid_y = binning.grid_shape(width, height)
    c = tiles.shape[0]
    img = tiles.reshape(c, grid_y, grid_x, TILE, TILE).permute(0, 1, 3, 2, 4)
    return img.reshape(c, grid_y * TILE, grid_x * TILE)[:, :height, :width]


def rasterize(proj: ProjectedGaussians, bg: torch.Tensor, width: int,
              height: int, pair_capacity: int | None = None,
              valid_capacity: int | None = None):
    """Binning then compositing; the oracle's contract (render includes the
    background). `pair_capacity` bounds the rect pair expansion,
    `valid_capacity` (default: the same) the pairs that survive the cull."""
    if pair_capacity is None:
        pair_capacity = default_pair_capacity(proj.mean2d.shape[0])
    table, aux = binning.bin_sorted_pairs(proj, width, height, pair_capacity,
                                          valid_capacity)
    return assemble(composite_frame(table, aux, width, height), aux, bg,
                    width, height)


def composite_frame(table, aux: dict, width: int, height: int):
    """K2 over every tile of a frame binned by ``bin_sorted_pairs`` (its
    table and aux): the tiles' colour (3, T, PIX), inverse depth and final
    T (T, PIX)."""
    grid_x, _ = binning.grid_shape(width, height)
    return composite(table, aux["tile_start"], aux["tile_end"], grid_x)[:3]


def assemble(tiles, aux: dict, bg: torch.Tensor, width: int, height: int):
    """:func:`rasterize`'s result from :func:`composite_frame`'s tiles and
    the binning's aux: the images cropped from the tile grid, the
    background added."""
    color_t, invd_t, t_t = tiles
    color = tiles_to_image(color_t, width, height)
    invd = tiles_to_image(invd_t[None], width, height)
    t_fin = tiles_to_image(t_t[None], width, height)
    return {
        "render": color + t_fin * bg[:, None, None],
        "invdepth": invd,
        "final_T": t_fin[0],
        "overflow": aux["overflow_rect"] + aux["overflow_valid"],
        "num_pairs": aux["num_valid"],
        "num_rect_pairs": aux["num_rect"],
    }


def default_pair_capacity(n: int) -> int:
    """Static pair capacity: ~4 tiles per Gaussian, power-of-two padded."""
    return int(max(2 ** int(np.ceil(np.log2(max(n * 4, 4096)))), 4096))


def round_capacity(pairs: int) -> int:
    """Smallest ladder capacity >= pairs, sixteenth-octave rungs, multiples
    of 4096 (the JAX package's ladder)."""
    pairs = max(int(pairs), 4096)
    k = max(int(np.ceil(np.log2(pairs))), 12)
    cands = [m * 2 ** (k - 3) for m in range(8, 16)
             if m * 2 ** (k - 3) % 4096 == 0] + [2 ** (k + 1)]
    cands += [m * 2 ** (k - 4) for m in range(9, 16)
              if m * 2 ** (k - 4) % 4096 == 0]
    cands += [m * 2 ** (k - 5) for m in range(17, 32)
              if m * 2 ** (k - 5) % 4096 == 0]
    return int(min(c for c in cands if c >= pairs))
