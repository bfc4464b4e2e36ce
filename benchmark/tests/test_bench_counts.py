"""The counts on a hand-countable scene: a round Gaussian whose alpha
reaches 1/255 on 29 pixels, three stacked ones where a pixel stops before
the third, and one too faint to count."""

import math

import pytest
import torch

from benchmark import counts as ct
from benchmark.reference import render as rr

W, H = 32, 16


def _scene():
    rows = [
        # mx, my, a, b, c, opacity, r, g, b, inverse depth
        [4.0, 4.0, 1.0, 0.0, 1.0, 0.5, 0.2, 0.4, 0.6, 1.0],
        [20.0, 8.0, 100.0, 0.0, 100.0, 0.98, 1.0, 0.0, 0.0, 1.0],
        [20.0, 8.0, 100.0, 0.0, 100.0, 0.98, 0.0, 1.0, 0.0, 0.5],
        [20.0, 8.0, 100.0, 0.0, 100.0, 0.98, 0.0, 0.0, 1.0, 0.25],
        [10.0, 10.0, 1.0, 0.0, 1.0, 0.003, 1.0, 1.0, 1.0, 1.0],
    ]
    attrs = torch.tensor(rows)
    depth = torch.tensor([1.0, 1.0, 2.0, 3.0, 1.0])
    radius = torch.tensor([10.0, 3.0, 3.0, 3.0, 10.0])
    return attrs, depth, radius


def _stats():
    attrs, depth, radius = _scene()
    pairs = rr.tile_pairs(attrs, depth, radius, W, H)
    out = rr.render(attrs, pairs, W, H, torch.zeros(3))
    return pairs, out, {"kept": int(out["kept"].sum()),
                        "needed_pairs": out["needed_pairs"],
                        "pixels": W * H, "tiles": 2, "visible": 5}


def test_pairs_and_evaluations_by_hand():
    pairs, out, s = _stats()
    # The faint Gaussian has no pair; the others one each.
    assert pairs["gid"].tolist() == [0, 1, 2, 3]
    assert pairs["tile_count"].tolist() == [1, 3]
    # 29 lattice points within sqrt(2 ln(127.5)) = 3.11 px of the centre.
    lattice = sum(1 for dx in range(-4, 5) for dy in range(-4, 5)
                  if dx * dx + dy * dy <= 2 * math.log(127.5))
    assert lattice == 29
    assert int(out["kept"][:, :16].sum()) == 29
    # The stacked pixel keeps two and stops before the third.
    assert int(out["kept"][8, 20]) == 2
    assert s["kept"] == 31
    # Pairs some pixel keeps: the round one and the first two stacked.
    assert s["needed_pairs"] == 3
    assert float(out["final_t"][8, 20]) == pytest.approx(0.02 * 0.02,
                                                         rel=1e-5)
    colour = out["colour"][:, 8, 20]
    torch.testing.assert_close(colour, torch.tensor([0.98, 0.02 * 0.98, 0.0]))


def test_kernel_counts_by_hand():
    _, _, s = _stats()
    assert ct.k2(s) == (20 * 31, 40 * 3 + 8 * 2 + 24 * W * H)
    assert ct.k3(s) == (67 * 31, 80 * 3 + 8 * 2 + 44 * W * H)
    assert ct.bound_s(*ct.k2(s)) == pytest.approx(
        (40 * 3 + 8 * 2 + 24 * W * H) / 3.35e12)
    assert ct.frame_ops(s) == ct.PROJECT_OPS * 5 + 20 * 31
    assert ct.step_ops(s, params=59 * 5, gaussians=5, depth=True) == (
        (405 + 810) * 5 + 87 * 31 + (3 * 495 + 5) * W * H + 14 * 59 * 5
        + 6 * 5)


def test_a_conic_that_is_not_positive_definite_keeps_gradients_finite():
    """Past the ellipse of a conic with a negative determinant (bfloat16
    rounding can make one) the power is positive and large: such pairs are
    skipped, and their exp must not overflow into the gradient."""
    attrs = torch.tensor([[16.0, 16.0, 1.0, 1.5, 1.0, 0.5, 0.2, 0.4, 0.6, 1.0],
                          [10.0, 10.0, 0.5, 0.0, 0.5, 0.5, 0.2, 0.4, 0.6, 1.0]])
    pairs = rr.tile_pairs(attrs, torch.tensor([1.0, 2.0]),
                          torch.tensor([30.0, 10.0]), 48, 48)
    out = rr.render(attrs, pairs, 48, 48, torch.zeros(3))
    g = rr.composite_backward(attrs, pairs, 48, 48, torch.ones(3, 48, 48),
                              torch.ones(48, 48), torch.ones(48, 48))
    assert torch.isfinite(out["image"]).all() and torch.isfinite(g).all()
    assert g.abs().sum() > 0


def test_a_culled_gaussian_on_the_camera_plane_gets_no_gradient():
    """The published rasterizer never differentiates a culled Gaussian; one
    lying on the camera's plane (z = 0) divides by zero in the projection,
    and its rows must still give a zero gradient, not 0 x NaN."""
    view = rr.view_matrices(torch.eye(3).numpy(), [0.0, 0.0, 0.0], 1.0, 0.7,
                            64, 48, "cpu")
    params = {"xyz": torch.tensor([[0.5, -0.3, 0.0], [0.1, 0.2, 2.0]]),
              "scaling": torch.log(torch.full((2, 3), 0.03)),
              "rotation": torch.tensor([[0.9, 0.1, 0.2, 0.3]] * 2),
              "opacity": torch.zeros(2, 1), "features_dc": torch.zeros(2, 3),
              "features_rest": torch.zeros(2, 45)}
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    proj = rr.project(leaves, view)
    assert proj["visible"].tolist() == [False, True]
    # The compositor gives a culled row no cotangent.
    cot = torch.ones_like(proj["attrs"]) * proj["visible"][:, None]
    grads = torch.autograd.grad(proj["attrs"], list(leaves.values()), cot)
    for g in grads:
        assert torch.isfinite(g).all()
        assert (g[0] == 0).all()
    assert (grads[0][1] != 0).any()
