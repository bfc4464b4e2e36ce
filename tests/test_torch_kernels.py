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
