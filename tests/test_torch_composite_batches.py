"""The compositor's plain versions against the JAX package's ``_make_composite``
(interpret mode) on scenes whose tiles hold 50-960 pairs: tile ranges that
cross the CUDA kernels' chunks of 32 pairs and batches of 128 (and 256),
with pixels that stop in a later batch. The card tests hold the kernels to
these plain versions at the same kinds of ranges. Also the kernels' warp
lists in their plain form: a warp never skips a pair one of its pixels
keeps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.core import transforms
from priordepth_gaussiansplatting_torch.ops import binning as pbin
from priordepth_gaussiansplatting_torch.ops import projection
from priordepth_gaussiansplatting_torch.ops import rasterize as prast
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.core import transforms as jtr
from priordepth_gaussiansplatting_tpu.ops import binning as jbin
from priordepth_gaussiansplatting_tpu.ops import projection as jproj
from priordepth_gaussiansplatting_tpu.ops import rasterize_pallas as rp
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)
EYE = (0.0, 0.0, -2.5)
CAPACITY = 8192

# name: (seed, Gaussians, image side, random_gaussians options)
SCENES = {
    "32px_700": (3, 700, 32, dict(extent=0.25, scale_range=(0.01, 0.04),
                                  opacity_range=(0.05, 0.35))),
    "32px_500": (6, 500, 32, dict(extent=0.22, scale_range=(0.005, 0.03),
                                  opacity_range=(0.1, 0.7))),
    "48px_1000": (7, 1000, 48, dict(extent=0.6, scale_range=(0.03, 0.09),
                                    opacity_range=(0.1, 0.7))),
}


def _tables(seed, n, wh, kw):
    """The port's and the JAX package's pair tables for the same projected
    Gaussians (JAX's projection, carried across)."""
    g = PT.random_gaussians(seed, n, **kw)
    cam = JT.look_at_camera(EYE, width=wh, height=wh)
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
    table, aux = pbin.bin_sorted_pairs(proj, wh, wh, CAPACITY)
    attrs16, aux_j = jbin.bin_sorted_pairs(proj_j, wh, wh, CAPACITY,
                                           interpret=True, exact_grads=True)
    return table.detach(), aux, attrs16, aux_j


def _to_tiles(img, grid_x, grid_y):
    """(C, H, W) with H, W multiples of 16 -> (C, num_tiles, PIX), the
    inverse of ``tiles_to_image``."""
    c = img.shape[0]
    return img.reshape(c, grid_y, 16, grid_x, 16).permute(0, 1, 3, 2, 4) \
        .reshape(c, grid_y * grid_x, 256).contiguous()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_composite_plain_versions_match_jax_across_batches(scene):
    seed, n, wh, kw = SCENES[scene]
    table, aux, attrs16, aux_j = _tables(seed, n, wh, kw)
    ts, te = aux["tile_start"], aux["tile_end"]
    grid_x, grid_y = pbin.grid_shape(wh, wh)
    counts = te - ts
    assert int(aux["overflow_valid"]) == 0 and int(counts.max()) > 256
    fwd = prast.composite_fwd_plain(table, ts, te, grid_x)
    stopped = fwd[3] < counts[:, None]
    assert bool((stopped & (fwd[3] > 128)).any()), "no stop in a later batch"

    comp = rp._make_composite(wh, wh, int(attrs16.shape[1]), True)
    tile_ids = jnp.arange(grid_x * grid_y, dtype=jnp.int32)
    outs_j, vjp = jax.vjp(lambda a: comp(a, tile_ids, aux_j["tile_start"],
                                         aux_j["tile_end"]), attrs16)
    imgs = (prast.tiles_to_image(fwd[0], wh, wh),
            prast.tiles_to_image(fwd[1][None], wh, wh),
            prast.tiles_to_image(fwd[2][None], wh, wh))
    for got, want in zip(imgs, outs_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5)

    rng = np.random.default_rng(1)
    cts = [rng.standard_normal((c, wh, wh)).astype(np.float32)
           for c in (3, 1, 1)]
    want = np.asarray(vjp(tuple(jnp.asarray(c) for c in cts))[0])
    cts_t = [_to_tiles(torch.from_numpy(c), grid_x, grid_y) for c in cts]
    got, n_eval = prast.composite_bwd_plain(
        table, ts, te, grid_x, cts_t[0], cts_t[1][0], cts_t[2][0], *fwd[:3])
    got = got.numpy()
    nv = int(aux["num_valid"])
    for r in range(pbin.ATTR_ROWS):
        a, b = got[r, :nv], want[r, :nv]
        tol = 3e-4 * np.abs(b).max() + 2e-3 * np.abs(b)
        assert (np.abs(a - b) <= tol).mean() >= 0.999, r
    assert np.abs(got[:, nv:]).max() == 0.0
    # The backward walks the forward's pairs: the same count per pixel.
    assert torch.equal(n_eval, fwd[3])


WALK_SCENES = dict(SCENES, mid_64px=(1, 600, 64, {}))


@pytest.mark.parametrize("scene", sorted(WALK_SCENES))
def test_walking_warps_hold_every_kept_pixel(scene):
    """The compositor kernels' warp lists, in their plain form: no pixel
    keeps a pair (power <= 0, alpha >= 1/255) that its warp does not walk,
    and the lists do leave pairs out."""
    seed, n, wh, kw = WALK_SCENES[scene]
    t = {k: torch.from_numpy(v)
         for k, v in PT.random_gaussians(seed, n, **kw).items()}
    cam = PT.look_at_camera(EYE, width=wh, height=wh, device="cpu")
    proj = projection.project_gaussians(
        t["means"], transforms.scaling_rotation_to_cov3d(t["scales"],
                                                         t["quats"]),
        t["opacities"], t["sh"], 3, cam.world_view, cam.full_proj,
        cam.cam_center, wh, wh, cam.tan_fovx, cam.tan_fovy,
        antialiasing=True)
    table, aux = pbin.bin_sorted_pairs(proj, wh, wh, CAPACITY)
    table = table.detach()
    ts, te = aux["tile_start"], aux["tile_end"]
    grid_x = pbin.grid_shape(wh, wh)[0]
    walks = prast.walking_warps_plain(table, ts, te, grid_x)
    pix = torch.arange(256)
    warp = (pix // 16 // 8) * 2 + pix % 16 // 8
    skipped = 0
    for tile, (s, e) in enumerate(zip(ts.tolist(), te.tolist())):
        if e <= s:
            continue
        p = table[:, s:e]
        ty, tx = divmod(tile, grid_x)
        dx = (tx * 16 + pix % 16).float()[:, None] - p[0]
        dy = (ty * 16 + pix // 16).float()[:, None] - p[1]
        power = -0.5 * (p[2] * dx * dx + p[4] * dy * dy) - p[3] * dx * dy
        alpha = torch.clamp_max(p[5] * torch.exp(power), prast.ALPHA_MAX)
        kept = (power <= 0) & (alpha >= prast.ALPHA_MIN)
        walked = (walks[s:e][None, :] >> warp[:, None]) & 1 == 1
        assert not bool((kept & ~walked).any()), tile
        skipped += int((~walked).sum())
    assert skipped > 0
