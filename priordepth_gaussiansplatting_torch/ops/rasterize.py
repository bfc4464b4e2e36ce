"""The tile rasterizer: binning (K1, K5) then the tile compositor (K2),
differentiable through the compositor's backward (K3) and the binning's
(K5b, K4); counterpart of the JAX package's
``ops/rasterize_pallas.py::rasterize``, ``_fwd_kernel`` and ``_bwd_kernel``.

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


def composite_fwd_plain(table, tile_start, tile_end, grid_x: int,
                        tiles=None):
    """Plain PyTorch version of K2 (see ``csrc/composite_fwd.cu``): a loop
    over tiles, vectorised over pixels and pairs within a tile."""
    dev = table.device
    if tiles is None:
        tiles = torch.arange(tile_start.shape[0], device=dev)
    n = tiles.shape[0]
    color = torch.zeros(3, n, PIX, device=dev)
    invd = torch.zeros(n, PIX, device=dev)
    final_t = torch.ones(n, PIX, device=dev)
    n_eval = torch.zeros(n, PIX, dtype=torch.int32, device=dev)
    t_list = tiles.tolist()
    starts = tile_start[tiles].tolist()
    ends = tile_end[tiles].tolist()
    for b, (t, s, e) in enumerate(zip(t_list, starts, ends)):
        if e > s:
            color[:, b], invd[b], final_t[b], n_eval[b] = \
                _composite_tile_plain(table[:, s:e], t, grid_x)
    return color, invd, final_t, n_eval


def composite_fwd(table, tile_start, tile_end, grid_x: int, tiles=None):
    """K2. Composites the listed tiles (all tiles when `tiles` is None) of
    the (ATTR_ROWS, L) tile-sorted pair table over their ranges
    [tile_start[t], tile_end[t]). Returns colour (3, n, PIX), inverse depth
    (n, PIX), final T (n, PIX) f32 and pairs evaluated per pixel (n, PIX)
    int32, with pixel index 16 * row + column inside the tile."""
    if table.device.type == "cpu":
        return composite_fwd_plain(table, tile_start, tile_end, grid_x, tiles)
    args = dict(table=table, tile_start=tile_start, tile_end=tile_end)
    if tiles is not None:
        args["tiles"] = tiles
    kernels.check_cuda("composite_fwd", **args)
    if table.dtype != torch.float32 or table.shape[0] != binning.ATTR_ROWS:
        raise ValueError("composite_fwd: table must be f32 (ATTR_ROWS, L)")
    if any(t.dtype != torch.int32 for k, t in args.items() if k != "table"):
        raise TypeError("composite_fwd: tile ranges and ids must be int32")
    n = tile_start.shape[0] if tiles is None else tiles.shape[0]
    dev = table.device
    color = torch.empty(3, n, PIX, device=dev)
    invd = torch.empty(n, PIX, device=dev)
    final_t = torch.empty(n, PIX, device=dev)
    n_eval = torch.empty(n, PIX, dtype=torch.int32, device=dev)
    p, i = kernels.ptr, kernels.i32
    kernels.launch("composite_fwd", [p, i, p, p, p, i, i, p, p, p, p],
                   table, table.shape[1], tile_start, tile_end, tiles, n,
                   grid_x, color, invd, final_t, n_eval)
    return color, invd, final_t, n_eval


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


def composite_bwd_plain(table, tile_start, tile_end, grid_x: int, d_color,
                        d_invd, d_final_t, color, invd, final_t, tiles=None):
    """Plain PyTorch version of K3 (see ``csrc/composite_bwd.cu``): a loop
    over tiles, vectorised over pixels and pairs within a tile."""
    dev = table.device
    if tiles is None:
        tiles = torch.arange(tile_start.shape[0], device=dev)
    d_table = torch.zeros_like(table)
    n_eval = torch.zeros(tiles.shape[0], PIX, dtype=torch.int32, device=dev)
    t_list = tiles.tolist()
    starts = tile_start[tiles].tolist()
    ends = tile_end[tiles].tolist()
    for i, (t, s, e) in enumerate(zip(t_list, starts, ends)):
        if e > s:
            d_table[:, s:e], n_eval[i] = _composite_tile_bwd_plain(
                table[:, s:e], t, grid_x, d_color[:, i], d_invd[i],
                d_final_t[i], color[:, i], invd[i], final_t[i])
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
    pixel = dict(d_invd=d_invd, d_final_t=d_final_t, invd=invd,
                 final_t=final_t)
    args = dict(table=table, tile_start=tile_start, tile_end=tile_end,
                d_color=d_color, color=color, **pixel)
    if tiles is not None:
        args["tiles"] = tiles
    kernels.check_cuda("composite_bwd", **args)
    if table.dtype != torch.float32 or table.shape[0] != binning.ATTR_ROWS:
        raise ValueError("composite_bwd: table must be f32 (ATTR_ROWS, L)")
    if any(t.dtype != torch.int32 for k, t in args.items()
           if k in ("tile_start", "tile_end", "tiles")):
        raise TypeError("composite_bwd: tile ranges and ids must be int32")
    for k, t in dict(d_color=d_color, color=color).items():
        if t.dtype != torch.float32 or t.shape != (3, n, PIX):
            raise ValueError(f"composite_bwd: {k} must be f32 (3, {n}, {PIX})")
    for k, t in pixel.items():
        if t.dtype != torch.float32 or t.shape != (n, PIX):
            raise ValueError(f"composite_bwd: {k} must be f32 ({n}, {PIX})")
    d_table = torch.zeros_like(table)
    n_eval = torch.empty(n, PIX, dtype=torch.int32, device=table.device)
    p, i = kernels.ptr, kernels.i32
    kernels.launch("composite_bwd", [p, i, p, p, p, i, i] + [p] * 8,
                   table, table.shape[1], tile_start, tile_end, tiles, n,
                   grid_x, d_color, d_invd, d_final_t, color, invd, final_t,
                   d_table, n_eval)
    return d_table, n_eval


class _Composite(torch.autograd.Function):
    """K2 forward, K3 backward; the custom VJP of the JAX package's
    ``_make_composite``. Saves the table, the tile ranges and K2's colour,
    inverse depth and final T; the pair counts are not differentiable."""

    @staticmethod
    def forward(ctx, table, tile_start, tile_end, grid_x, tiles):
        color, invd, final_t, n_eval = composite_fwd(table, tile_start,
                                                     tile_end, grid_x, tiles)
        extra = () if tiles is None else (tiles,)
        ctx.save_for_backward(table, tile_start, tile_end, color, invd,
                              final_t, *extra)
        ctx.grid_x = grid_x
        ctx.mark_non_differentiable(n_eval)
        return color, invd, final_t, n_eval

    @staticmethod
    def backward(ctx, d_color, d_invd, d_final_t, _):
        table, ts, te, color, invd, final_t, *extra = ctx.saved_tensors
        d_table, _ = composite_bwd(
            table, ts, te, ctx.grid_x, d_color.contiguous(),
            d_invd.contiguous(), d_final_t.contiguous(), color, invd,
            final_t, tiles=extra[0] if extra else None)
        return d_table, None, None, None, None


def composite(table, tile_start, tile_end, grid_x: int, tiles=None):
    """Differentiable :func:`composite_fwd` (gradient with respect to the
    table, by K3)."""
    return _Composite.apply(table, tile_start, tile_end, grid_x, tiles)


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
    n = proj.mean2d.shape[0]
    if pair_capacity is None:
        pair_capacity = default_pair_capacity(n)
    table, aux = binning.bin_sorted_pairs(proj, width, height, pair_capacity,
                                          valid_capacity)
    grid_x, _ = binning.grid_shape(width, height)
    color_t, invd_t, t_t, _ = composite(table, aux["tile_start"],
                                        aux["tile_end"], grid_x)
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
