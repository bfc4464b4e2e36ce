"""The tile-band compositor (K6) on the CPU: its plain version against the
JAX package's ``composite_bands`` in interpret mode, forward and VJP, on a
9-tile frame cut into bands with pad slots; and the bands against the
port's whole-frame compositor: assembled forward and summed VJPs equal to
it exactly, since the bands' pair columns are disjoint."""

import functools

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
WH = 48  # a 3 x 3 tile grid
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3
SCENES = {
    "sparse": (dict(seed=7, n=96), (0.0, 0.0, -2.5)),
    "dense_overlap": (dict(seed=5, n=128, extent=0.3, scale_range=(0.1, 0.3),
                           opacity_range=(0.9, 0.99)), (0.0, 0.0, -2.0)),
}


@functools.lru_cache(maxsize=None)
def tables(scene):
    """The port's and the JAX package's pair tables and tile ranges for the
    same projected Gaussians (JAX's projection, carried across)."""
    kw, eye = SCENES[scene]
    kw = dict(kw)
    g = PT.random_gaussians(kw.pop("seed"), kw.pop("n"), **kw)
    cam = JT.look_at_camera(eye, width=WH, height=WH)
    proj_j = jproj.project_gaussians(
        jnp.asarray(g["means"]),
        jtr.scaling_rotation_to_cov3d(jnp.asarray(g["scales"]),
                                      jnp.asarray(g["quats"])),
        jnp.asarray(g["opacities"]), jnp.asarray(g["sh"]), 3,
        cam.world_view, cam.full_proj, cam.cam_center, WH, WH,
        cam.tan_fovx, cam.tan_fovy)
    proj = interop.projected_from_numpy(
        *(np.asarray(getattr(proj_j, f)) for f in
          ("mean2d", "conic", "opacity", "rgb", "depth", "invdepth",
           "radius")), device="cpu")
    table, aux = pbin.bin_sorted_pairs(proj, WH, WH, 8192)
    attrs16, aux_j = jbin.bin_sorted_pairs(proj_j, WH, WH, 8192,
                                           interpret=True, exact_grads=True)
    return table.detach(), aux, attrs16, aux_j


def cotangents(n_slots, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((c, n_slots, prast.PIX)).astype(np.float32)
            for c in (3, 1, 1)]


def port_band(table, aux, n_bands, band, cts=None):
    """One band's raw outputs and, given cotangents, its table VJP."""
    ids, start, end = prast.band_slots(aux["tile_start"], aux["tile_end"],
                                       n_bands, band)
    tab = table.clone().requires_grad_(True)
    outs = prast.composite_bands(tab, ids, start, end, WH, WH)
    if cts is None:
        return [o.detach() for o in outs], None
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    return [o.detach() for o in outs], torch.autograd.grad(loss, tab)[0]


def test_band_slots_pad_like_jax():
    """9 tiles in 4 bands: 3 slots each, the last band holding tile 8 and
    two pads (id 0, empty range), as ``_rasterize_tile_sharded`` pads."""
    ts = torch.arange(9, dtype=torch.int32) * 10
    te = ts + 5
    got = [prast.band_slots(ts, te, 4, m) for m in range(4)]
    assert [g[0].tolist() for g in got] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                            [0, 0, 0]]
    assert got[2][1].tolist() == [60, 70, 80]
    assert got[3][1].tolist() == [0, 0, 0] and got[3][2].tolist() == [0, 0, 0]
    assert all(x.dtype == torch.int32 for g in got for x in g)
    ids, start, end = prast.band_slots(ts, te, 2, 1)
    assert ids.tolist() == [5, 6, 7, 8, 0]
    assert end.tolist() == [55, 65, 75, 85, 0]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_composite_bands_plain_matches_jax(scene):
    """Forward atol 2e-5; table VJP atol 3e-4 max|g| + rtol 2e-3 (the
    gradient rule of tests/test_pallas_vs_oracle.py) on >= 99.9% of the
    kept pairs' entries, and zero outside each band's pairs."""
    n_bands = 4
    table, aux, attrs16, aux_j = tables(scene)
    nt = 9
    band = -(-nt // n_bands)
    pad = band * n_bands - nt
    ids_j = jnp.pad(jnp.arange(nt, dtype=jnp.int32), (0, pad))
    starts_j = jnp.pad(aux_j["tile_start"], (0, pad))
    ends_j = jnp.pad(aux_j["tile_end"], (0, pad))
    nv = int(aux["num_valid"])
    assert nv > 0 and int(aux_j["num_valid"]) == nv
    for m in range(n_bands):
        sl = slice(m * band, (m + 1) * band)
        cts = cotangents(band, seed=m)
        outs, d_table = port_band(table, aux, n_bands, m, cts)
        outs_j, vjp = jax.vjp(
            lambda a: rp.composite_bands(a, ids_j[sl], starts_j[sl],
                                         ends_j[sl], WH, WH, interpret=True),
            attrs16)
        for got, want in zip(outs, outs_j):
            # JAX's raw tiles are (slots, PIX, C); the port's (C, slots, PIX)
            want = np.asarray(want).transpose(2, 0, 1)
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
        want_g = np.asarray(vjp(tuple(jnp.asarray(c.transpose(1, 2, 0))
                                      for c in cts))[0])
        got_g = d_table.numpy()
        for r in range(pbin.ATTR_ROWS):
            a, b = got_g[r, :nv], want_g[r, :nv]
            tol = (GRAD_ATOL * max(np.abs(b).max(), 1e-30)
                   + GRAD_RTOL * np.abs(b))
            assert (np.abs(a - b) <= tol).mean() >= 0.999, (m, r)
        ids, start, end = prast.band_slots(aux["tile_start"], aux["tile_end"],
                                           n_bands, m)
        own = np.zeros(got_g.shape[1], bool)
        for s, e in zip(start.tolist(), end.tolist()):
            own[s:e] = True
        assert np.abs(got_g[:, ~own]).max() == 0.0, m
        if m == n_bands - 1:  # tile 8 then two pads: nothing composited
            assert outs[0][:, 1:].abs().max() == 0.0
            assert torch.all(outs[2][:, 1:] == 1.0)


@pytest.mark.parametrize("n_bands", [2, 3, 4])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_bands_sum_to_the_whole_frame(scene, n_bands):
    table, aux, _, _ = tables(scene)
    ts, te = aux["tile_start"], aux["tile_end"]
    grid_x, _ = pbin.grid_shape(WH, WH)
    nt = ts.shape[0]
    band = -(-nt // n_bands)
    cts = cotangents(band * n_bands, seed=11)
    outs, grads = [], []
    for m in range(n_bands):
        sl = slice(m * band, (m + 1) * band)
        o, g = port_band(table, aux, n_bands, m, [c[:, sl] for c in cts])
        outs.append(o)
        grads.append(g)
    tab = table.clone().requires_grad_(True)
    color, invd, t_fin, _ = prast.composite(tab, ts, te, grid_x)
    whole = [color, invd[None], t_fin[None]]
    for k in range(3):
        assembled = torch.cat([o[k] for o in outs], 1)[:, :nt]
        assert torch.equal(assembled, whole[k].detach()), k
        img = prast.tiles_to_image(assembled, WH, WH)
        assert torch.equal(img, prast.tiles_to_image(whole[k].detach(), WH,
                                                     WH))
    loss = sum((o * torch.from_numpy(c[:, :nt])).sum()
               for o, c in zip(whole, cts))
    want = torch.autograd.grad(loss, tab)[0]
    summed = grads[0]
    for g in grads[1:]:
        summed = summed + g
    assert torch.equal(summed, want)
    assert float(want.abs().max()) > 0
