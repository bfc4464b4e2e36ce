"""Plain reference of the render: projection with SH, binning, and the
front-to-back compositor, forward and backward, in plain PyTorch.

It follows the 3D Gaussian Splatting rasterizer's published semantics
(Kerbl et al. 2023, and its CUDA reference's ``preprocessCUDA`` /
``renderCUDA``) as the measured program states them:

  * cull where camera-space z <= 0.2; J takes t.x/t.y clamped to
    +-1.3 tan(fov/2) z; the 2D covariance is dilated by 0.3 on its diagonal;
    radius = ceil(3 sqrt(lambda_max)), lambda_max floored by a 0.1 gap;
  * pixel coordinates ((ndc + 1) S - 1) / 2; conic, opacity, colour and
    inverse depth are rounded once to bfloat16 (to nearest even) and kept in
    float32, with an identity gradient; the mean stays float32;
  * alpha = min(0.99, opacity exp(power)), skipped where power > 0 or
    alpha < 1/255; a pixel stops before the pair that would take its
    transmittance below 1e-4; no gradient flows through the clamp, the skips
    or the stop; the background is added after compositing and the image is
    clamped to [0, 1].

Nothing here is read from the measured program: the pairs are found again
from the alpha >= 1/255 support of each Gaussian inside its 3-sigma tile
rectangle, ordered by (tile, depth, index), and composited tile block by
tile block with prefix products, so that any scene size fits. Gradients
come from autograd: the forward is recomputed block by block against the
loss's cotangents.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TILE = 16
PIX = TILE * TILE
NEAR_Z = 0.2
DILATION = 0.3
LAMBDA_FLOOR = 0.1
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
# Elements of one (tiles, pixels, pairs) block; bounds the reference's
# memory at any scene size.
BLOCK_ELEMENTS = 1 << 26

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# Columns of the per-Gaussian attribute matrix the compositor reads.
MX, MY, CA, CB, CC, OP, R, G, B, INVD = range(10)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bfloat16 value, staying in x's dtype, with an
    identity gradient."""
    if x.dtype != torch.float32:
        return x
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x.detach())


def sh_colour(coeffs: torch.Tensor, dirs: torch.Tensor, degree: int):
    """Colour of real SH up to `degree` (<= 3) from (N, 3K) channel-minor
    coefficients and unit directions: eval + 0.5, floored at 0."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz,
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                  SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    k = len(basis)
    c = coeffs[:, :3 * k].reshape(-1, k, 3)
    colour = (torch.stack(basis, -1)[..., None] * c).sum(-2)
    return torch.clamp_min(colour + 0.5, 0.0)


def covariance(log_scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """R diag(exp(s))^2 R^T for (w, x, y, z) quaternions, (N, 3, 3)."""
    q = quat / torch.clamp_min(torch.linalg.vector_norm(quat, dim=-1,
                                                        keepdim=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rot = torch.stack([
        1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
        2.0 * (x * z + w * y),
        2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
        2.0 * (y * z - w * x),
        2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
        1.0 - 2.0 * (x * x + y * y)], -1).reshape(-1, 3, 3)
    s = torch.exp(log_scale)
    s2 = s * s
    rows = [rot[:, 0, :], rot[:, 1, :], rot[:, 2, :]]

    def e(i, j):
        return torch.sum(s2 * rows[i] * rows[j], dim=-1)

    return torch.stack([torch.stack([e(0, 0), e(0, 1), e(0, 2)], -1),
                        torch.stack([e(0, 1), e(1, 1), e(1, 2)], -1),
                        torch.stack([e(0, 2), e(1, 2), e(2, 2)], -1)], -2)


def project(params: dict, view: dict, sh_degree: int = 3,
            screen_offset: torch.Tensor | None = None) -> dict:
    """Per-Gaussian screen attributes of `params` (storage spaces: xyz,
    features_dc, features_rest, scaling, rotation, opacity logits) seen by
    `view` (world_view, full_proj, cam_center, width, height, tan_fovx,
    tan_fovy). Returns the (N, 10) attribute matrix, depth (N,), radius
    (N,) and the visible mask."""
    dt = params["xyz"].dtype
    wv = view["world_view"].to(dt)
    fp = view["full_proj"].to(dt)
    # The published rasterizer never differentiates a culled Gaussian: its
    # rows are computed here from a point in front of the camera instead,
    # so that no inf or NaN of theirs (a Gaussian on the camera's plane
    # divides by z = 0) reaches a gradient as 0 x NaN.
    with torch.no_grad():
        cull = (params["xyz"] @ wv[:3, :3].T + wv[:3, 3])[:, 2] <= NEAR_Z
        front = (torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=wv.device)
                 - wv[:3, 3]) @ wv[:3, :3]
    xyz = torch.where(cull[:, None], front, params["xyz"])
    width, height = view["width"], view["height"]
    tx, ty = view["tan_fovx"], view["tan_fovy"]
    focal_x = width / (2.0 * tx)
    focal_y = height / (2.0 * ty)

    hom = xyz @ fp[:3, :3].T + fp[:3, 3]
    w = xyz @ fp[3, :3] + fp[3, 3]
    ndc = hom * (1.0 / (w + 1e-7))[:, None]
    mean2d = torch.stack([((ndc[:, 0] + 1.0) * width - 1.0) * 0.5,
                          ((ndc[:, 1] + 1.0) * height - 1.0) * 0.5], -1)
    if screen_offset is not None:
        mean2d = mean2d + screen_offset

    cov3d = covariance(params["scaling"], params["rotation"])
    rw = wv[:3, :3]
    t = xyz @ rw.T + wv[:3, 3]
    tz = t[:, 2]
    txz = torch.clamp(t[:, 0] / tz, -1.3 * tx, 1.3 * tx) * tz
    tyz = torch.clamp(t[:, 1] / tz, -1.3 * ty, 1.3 * ty) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(tz)
    j0 = torch.stack([focal_x * inv_z, zeros, -focal_x * txz * inv_z2],
                     -1) @ rw
    j1 = torch.stack([zeros, focal_y * inv_z, -focal_y * tyz * inv_z2],
                     -1) @ rw

    def quad(a, b):
        s = cov3d
        return (a[:, 0] * b[:, 0] * s[:, 0, 0] + a[:, 1] * b[:, 1] * s[:, 1, 1]
                + a[:, 2] * b[:, 2] * s[:, 2, 2]
                + (a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0]) * s[:, 0, 1]
                + (a[:, 0] * b[:, 2] + a[:, 2] * b[:, 0]) * s[:, 0, 2]
                + (a[:, 1] * b[:, 2] + a[:, 2] * b[:, 1]) * s[:, 1, 2])

    cxx = quad(j0, j0) + DILATION
    cyy = quad(j1, j1) + DILATION
    cxy = quad(j0, j1)
    det = cxx * cyy - cxy * cxy
    det_inv = torch.where(det != 0.0, 1.0 / det, torch.zeros_like(det))
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, LAMBDA_FLOOR))
    cull = cull | (det == 0.0)
    radius = torch.where(cull, torch.zeros_like(lam),
                         torch.ceil(3.0 * torch.sqrt(lam))).detach()
    opacity = torch.sigmoid(params["opacity"][:, 0])
    opacity = torch.where(cull, torch.zeros_like(opacity), opacity)

    dirs = xyz - view["cam_center"].to(dt)[None, :]
    dirs = dirs / torch.clamp_min(torch.linalg.vector_norm(dirs, dim=-1,
                                                           keepdim=True),
                                  1e-12)
    feats = torch.cat([params["features_dc"], params["features_rest"]], 1)
    rgb = sh_colour(feats, dirs, sh_degree)
    invdepth = torch.where(cull, torch.zeros_like(tz),
                           1.0 / torch.clamp_min(tz, 1e-6))
    attrs = torch.cat([mean2d, round_bf16(conic),
                       round_bf16(opacity)[:, None], round_bf16(rgb),
                       round_bf16(invdepth)[:, None]], 1)
    depth = torch.where(cull, torch.full_like(tz, math.inf), tz).detach()
    return {"attrs": attrs, "depth": depth, "radius": radius,
            "visible": radius > 0}


def tile_pairs(attrs: torch.Tensor, depth: torch.Tensor, radius: torch.Tensor,
               width: int, height: int) -> dict:
    """The (Gaussian, tile) pairs a frame composites: every tile of a
    Gaussian's 3-sigma rectangle that its alpha >= 1/255 ellipse (with one
    pixel of margin) reaches, ordered by tile, then depth, then index.
    Returns the pairs' Gaussian ids (P,) and per tile its first pair and
    pair count."""
    a = attrs.detach()
    grid_x, grid_y = -(-width // TILE), -(-height // TILE)
    ca, cb, cc, op = a[:, CA], a[:, CB], a[:, CC], a[:, OP]
    det = ca * cc - cb * cb
    tau = torch.clamp_min(2.0 * torch.log(torch.clamp_min(op, 1e-12)
                                          / ALPHA_MIN), 0.0)
    inv = 1.0 / torch.clamp_min(det, 1e-30)
    r3 = radius.to(a.dtype)
    rx = torch.minimum(torch.sqrt(torch.clamp_min(tau * cc * inv, 0.0)) + 1.0,
                       r3)
    ry = torch.minimum(torch.sqrt(torch.clamp_min(tau * ca * inv, 0.0)) + 1.0,
                       r3)

    def cell(v, hi):
        return torch.clamp(torch.floor(v / TILE), 0, hi).long()

    x0 = cell(a[:, MX] - rx, grid_x)
    y0 = cell(a[:, MY] - ry, grid_y)
    x1 = torch.maximum(cell(a[:, MX] + rx + TILE - 1, grid_x), x0)
    y1 = torch.maximum(cell(a[:, MY] + ry + TILE - 1, grid_y), y0)
    empty = (radius <= 0) | (op < ALPHA_MIN)
    nx = torch.where(empty, torch.zeros_like(x0), x1 - x0)
    count = nx * (y1 - y0)
    order = torch.sort(torch.where(empty, torch.full_like(depth, math.inf),
                                   depth), stable=True).indices
    per = count[order]
    gid = torch.repeat_interleave(order, per)
    first = torch.cumsum(per, 0) - per
    local = (torch.arange(gid.shape[0], device=gid.device)
             - torch.repeat_interleave(first, per))
    w = nx[gid].clamp_min(1)
    tile = (y0[gid] + local // w) * grid_x + x0[gid] + local % w
    by_tile = torch.sort(tile, stable=True).indices
    counts = torch.bincount(tile, minlength=grid_x * grid_y)
    return {"gid": gid[by_tile], "tile_first": torch.cumsum(counts, 0) - counts,
            "tile_count": counts, "grid": (grid_x, grid_y)}


def tile_blocks(counts: torch.Tensor):
    """Tiles grouped into blocks of similar pair counts, each with at most
    BLOCK_ELEMENTS (tile, pixel, pair) elements: a list of (tile ids,
    width)."""
    order = torch.argsort(counts, descending=True)
    sizes = counts[order].tolist()
    blocks, start = [], 0
    while start < len(sizes) and sizes[start] > 0:
        k = sizes[start]
        n = max(1, min(BLOCK_ELEMENTS // (PIX * k), len(sizes) - start))
        blocks.append((order[start:start + n], k))
        start += n
    return blocks


def composite_block(attrs: torch.Tensor, pairs: dict, tiles: torch.Tensor,
                    k: int):
    """Composite `tiles` (B,) over their first `k` pairs: colour (B, PIX, 3),
    inverse depth and final T (B, PIX), and per pixel the pairs it kept
    (alpha >= 1/255 before its stop) and per tile whether each pair column
    was kept by some pixel (B, k)."""
    grid_x = pairs["grid"][0]
    dev = attrs.device
    col = torch.arange(k, device=dev)
    n = pairs["tile_count"][tiles]
    valid = col[None, :] < n[:, None]
    idx = torch.where(valid, pairs["tile_first"][tiles][:, None] + col, 0)
    g = attrs[pairs["gid"][idx]]                      # (B, k, 10)
    pix = torch.arange(PIX, device=dev)
    tx = (tiles % grid_x) * TILE
    ty = (tiles // grid_x) * TILE
    px = (tx[:, None] + pix % TILE).to(attrs.dtype)[:, :, None]
    py = (ty[:, None] + pix // TILE).to(attrs.dtype)[:, :, None]
    dx = px - g[:, None, :, MX]
    dy = py - g[:, None, :, MY]
    power = (-0.5 * (g[:, None, :, CA] * dx * dx + g[:, None, :, CC] * dy * dy)
             - g[:, None, :, CB] * dx * dy)
    # A pair with power > 0 is skipped whatever its alpha; exp(min(power, 0))
    # keeps its unused branch finite, so that no 0 x inf reaches a gradient
    # where a conic is not positive definite.
    alpha = torch.clamp_max(
        g[:, None, :, OP] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid[:, None, :]
    a = torch.where(keep, alpha, torch.zeros_like(alpha))
    cum = torch.cumprod(1.0 - a, dim=-1)
    live = cum >= T_EPS
    t_excl = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], -1)
    w = torch.where(live, a * t_excl, torch.zeros_like(a))
    colour = torch.stack([(w * g[:, None, :, c]).sum(-1) for c in (R, G, B)],
                         -1)
    invd = (w * g[:, None, :, INVD]).sum(-1)
    final_t = torch.where(live, 1.0 - a, torch.ones_like(a)).prod(-1)
    used = keep & live
    return colour, invd, final_t, used.sum(-1), used.any(1)


def _to_image(tiles: torch.Tensor, values: torch.Tensor, pairs: dict,
              out: torch.Tensor, width: int, height: int) -> None:
    """Scatter (B, PIX, C) tile values into the (C, H, W) image `out`."""
    grid_x = pairs["grid"][0]
    pix = torch.arange(PIX, device=tiles.device)
    y = (tiles // grid_x * TILE)[:, None] + pix // TILE
    x = (tiles % grid_x * TILE)[:, None] + pix % TILE
    inside = (y < height) & (x < width)
    out[:, y[inside], x[inside]] = values[inside].T.to(out.dtype)


def render(attrs: torch.Tensor, pairs: dict, width: int, height: int,
           bg: torch.Tensor) -> dict:
    """Forward render without gradients: the clamped image (3, H, W),
    inverse depth and final T (H, W), kept evaluations per pixel (H, W) and
    the number of pair columns some pixel kept."""
    dt, dev = attrs.dtype, attrs.device
    colour = torch.zeros(3, height, width, dtype=dt, device=dev)
    invd = torch.zeros(1, height, width, dtype=dt, device=dev)
    final_t = torch.ones(1, height, width, dtype=dt, device=dev)
    kept = torch.zeros(1, height, width, dtype=torch.int64, device=dev)
    needed_pairs = 0
    with torch.no_grad():
        for tiles, k in tile_blocks(pairs["tile_count"]):
            c, i, t, u, cols = composite_block(attrs, pairs, tiles, k)
            _to_image(tiles, c, pairs, colour, width, height)
            _to_image(tiles, i[..., None], pairs, invd, width, height)
            _to_image(tiles, t[..., None], pairs, final_t, width, height)
            _to_image(tiles, u[..., None], pairs, kept, width, height)
            needed_pairs += int(cols.sum())
        image = torch.clamp(colour + final_t * bg.to(dt)[:, None, None],
                            0.0, 1.0)
    return {"image": image, "colour": colour, "invdepth": invd[0],
            "final_t": final_t[0], "kept": kept[0],
            "needed_pairs": needed_pairs}


def composite_backward(attrs: torch.Tensor, pairs: dict, width: int,
                       height: int, d_colour: torch.Tensor,
                       d_invd: torch.Tensor,
                       d_final_t: torch.Tensor) -> torch.Tensor:
    """d(loss)/d(attrs) (N, 10), given the loss's cotangents of the
    unclamped colour (3, H, W), inverse depth and final T (H, W): each
    block's forward is recomputed under autograd and differentiated."""
    leaf = attrs.detach().requires_grad_(True)
    grid_x = pairs["grid"][0]
    pix = torch.arange(PIX, device=attrs.device)
    for tiles, k in tile_blocks(pairs["tile_count"]):
        y = (tiles // grid_x * TILE)[:, None] + pix // TILE
        x = (tiles % grid_x * TILE)[:, None] + pix % TILE
        inside = (y < height) & (x < width)
        yc, xc = y.clamp_max(height - 1), x.clamp_max(width - 1)

        def cot(field):
            v = field[..., yc, xc]
            return torch.where(inside, v, torch.zeros_like(v))

        with torch.enable_grad():
            c, i, t, _, _ = composite_block(leaf, pairs, tiles, k)
            torch.autograd.backward(
                [c, i, t], [cot(d_colour).permute(1, 2, 0), cot(d_invd),
                            cot(d_final_t)])
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


def view_matrices(rot, trans, fovx: float, fovy: float, width: int,
                  height: int, device, znear: float = 0.01,
                  zfar: float = 100.0) -> dict:
    """A view from COLMAP-style extrinsics (`rot` camera-to-world, `trans`
    world-to-camera) as the 3DGS reference builds it: world-to-view and the
    OpenGL-style projection (z in [0, 1]), float32, column vectors."""
    w2c = np.zeros((4, 4), dtype=np.float64)
    w2c[:3, :3] = np.asarray(rot, np.float64).T
    w2c[:3, 3] = np.asarray(trans, np.float64)
    w2c[3, 3] = 1.0
    w2c = w2c.astype(np.float32)
    tan_x, tan_y = math.tan(fovx / 2.0), math.tan(fovy / 2.0)
    proj = np.zeros((4, 4), dtype=np.float32)
    proj[0, 0] = 1.0 / tan_x
    proj[1, 1] = 1.0 / tan_y
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    centre = np.linalg.inv(w2c)[:3, 3]

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return {"world_view": dev(w2c), "full_proj": dev(proj @ w2c),
            "cam_center": dev(centre), "width": int(width),
            "height": int(height), "tan_fovx": tan_x, "tan_fovy": tan_y}
