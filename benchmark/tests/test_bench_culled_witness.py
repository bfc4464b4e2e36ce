"""A witness, independent of the program's gradient and of the reference's,
for what a Gaussian that the projection culls (camera-space z <= 0.2, here
on the camera's plane, z = 0) should receive: finite differences of the
loss through the program's own forward. The row adds nothing to the image
wherever it is moved, scaled or turned while it stays culled, so its true
gradient is 0, as the published rasterizer's backward (which returns for a
row of radius 0) gives it. The reference gives that 0."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import drivers, inputs
from benchmark.reference import render as rr
from benchmark.reference import train as rt
from benchmark.tests.conftest import SEED, tiny_config, tiny_mix

from priordepth_gaussiansplatting_torch.core import cameras
from priordepth_gaussiansplatting_torch.ops import render

ROW = 0
# Camera-space position of the culled row: on the camera's plane.
ON_PLANE = (0.3, -0.2, 0.0)


@pytest.fixture(scope="module")
def scene():
    cfg = tiny_config("tandt-truck-1.7m")
    drv = drivers.load("render")(cfg, tiny_mix("render_closed"), SEED, "cpu")
    params = drv.store_params()
    # A camera at the origin looking along +z, so that the row's
    # camera-space z is exactly 0.
    fovx, fovy = 1.2, 0.9
    w, h = cfg["width"], cfg["height"]
    cam = cameras.make_camera(np.eye(3), [0.0, 0.0, 0.0], fovx, fovy, w, h,
                              device="cpu")
    view = rr.view_matrices(np.eye(3), [0.0, 0.0, 0.0], fovx, fovy, w, h,
                            "cpu")
    params["xyz"][ROW] = torch.tensor(ON_PLANE)
    target = inputs.target(cfg, SEED, 0, "cpu")
    return drv, cfg, params, cam, view, target


def _port_loss(drv, params, cam, target) -> torch.Tensor:
    state = drv.state(0)
    state = dataclasses.replace(
        state, params=dataclasses.replace(state.params, **params))
    out = render.render(cam, state, drv.bg(), backend="kernels",
                        pair_capacity=1 << 16)
    assert int(out["overflow"]) == 0
    return (out["render"] - target).abs().mean()


MOVES = [("xyz", (0, 0.01)), ("xyz", (1, -0.02)), ("xyz", (2, 0.05)),
         ("scaling", (0, 0.3)), ("scaling", (2, -0.3)),
         ("rotation", (1, 0.2)), ("rotation", (3, -0.2))]


@pytest.mark.parametrize("group, move", MOVES)
def test_the_culled_row_leaves_the_programs_loss_unmoved(scene, group, move):
    drv, _, params, cam, _, target = scene
    base = _port_loss(drv, params, cam, target)
    moved = {k: v.clone() for k, v in params.items()}
    moved[group][ROW, move[0]] += move[1]
    assert torch.equal(_port_loss(drv, moved, cam, target), base)


def test_the_reference_gives_the_culled_row_a_zero_gradient(scene):
    drv, cfg, params, _, view, target = scene
    proj = rr.project(params, view, cfg["sh_degree"])
    assert not bool(proj["visible"][ROW])
    assert int(proj["visible"].sum()) > 10
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    _, grads, *_ = rt.step(params, zeros, zeros, 15000, view, target, None,
                           drv.bg(), 15001, cfg["optimization"], drv.extent,
                           cfg["sh_degree"])
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        assert bool((g[ROW] == 0).all()), (k, g[ROW])
    # The rows that are seen do get a gradient.
    assert float(grads["xyz"].abs().sum()) > 0
