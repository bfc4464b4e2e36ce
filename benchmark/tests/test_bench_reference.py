"""The plain reference against the port's CPU path at a tiny size, and its
control (the reference in bfloat16) failing the limits."""

import json
import math

import pytest
import torch

from benchmark import drivers, harness, inputs
from benchmark.drivers import train as train_driver
from benchmark.reference import render as rr
from benchmark.tests.conftest import SEED, tiny_config, tiny_mix

from priordepth_gaussiansplatting_torch.ops import projection, render
from priordepth_gaussiansplatting_torch.train import step as step_lib


def _render_driver(config="m360-mean-3m"):
    drv = drivers.load("render")(tiny_config(config),
                                 tiny_mix("render_closed"), SEED, "cpu")
    drv.setup()
    return drv


def test_projection_matches_the_port():
    drv = _render_driver()
    v = drv.test_idx[1]
    cam = drv.cams[1]
    st = drv.state_
    port = projection.project_gaussians(
        st.params.xyz, st.get_covariance(), st.get_opacity(),
        st.get_features(), st.max_sh_degree, cam.world_view, cam.full_proj,
        cam.cam_center, cam.width, cam.height, cam.tan_fovx, cam.tan_fovy)
    ref = rr.project(drv.store_params(), drv.view(v))
    assert torch.equal(ref["radius"], port.radius.float())
    # Culled rows composite nothing; the rest must agree.
    vis = port.radius > 0
    assert 0 < int(vis.sum()) < vis.shape[0]
    a = ref["attrs"][vis]
    torch.testing.assert_close(a[:, :2], port.mean2d[vis], rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(a[:, rr.CA:rr.CC + 1], port.conic[vis],
                               rtol=1e-2, atol=1e-6)
    torch.testing.assert_close(ref["attrs"][:, rr.OP], port.opacity)
    torch.testing.assert_close(a[:, rr.R:rr.B + 1], port.rgb[vis], rtol=1e-2,
                               atol=1e-6)


@pytest.mark.parametrize("config", ["m360-mean-3m", "tandt-truck-1.7m"])
def test_render_matches_the_port(config):
    drv = _render_driver(config)
    for i, v in enumerate(drv.test_idx[:2]):
        out = step_lib.eval_image(drv.cams[i], drv.state_, drv.bg_,
                                  backend="kernels",
                                  pair_capacity=drv.capacity)
        ref = drv.reference_image(v)
        assert int(out["overflow"]) == 0
        assert 0.05 < float(ref.mean()) < 0.95
        torch.testing.assert_close(out["render"], ref, rtol=0, atol=1e-5)
        # Also the inverse depth, which the port's render returns.
        r = render.render(drv.cams[i], drv.state_, drv.bg_, backend="kernels",
                          pair_capacity=drv.capacity)
        params = drv.store_params()
        proj = rr.project(params, drv.view(v))
        pairs = rr.tile_pairs(proj["attrs"], proj["depth"], proj["radius"],
                              64, 48)
        full = rr.render(proj["attrs"], pairs, 64, 48, drv.bg_)
        torch.testing.assert_close(r["invdepth"][0], full["invdepth"],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("config", ["m360-mean-3m", "tandt-truck-1.7m"])
def test_train_steps_match_the_port(config):
    drv = drivers.load("train")(tiny_config(config),
                                tiny_mix("train_steady"), SEED, "cpu")
    drv.setup()
    drv.release()
    got = drv.check()
    assert set(got) == {"loss_gap", "grad_gap", "change_gap", "stats_gap"}
    assert all(v < 1e-5 for v in got.values()), got
    assert len(drv.program["loss"]) == 3 and drv.program["views"] == sorted(
        set(drv.program["views"]), key=drv.program["views"].index)


def test_the_control_fails_the_limits():
    """The reference in bfloat16, in the program's place, fails one of each
    cell's numbers; the half-image fault too."""
    limits = {p.stem: json.loads(p.read_text())
              for p in (harness.ROOT / "limits").glob("*.json")}
    drv = drivers.load("train")(tiny_config("m360-mean-3m"),
                                tiny_mix("train_steady"), SEED, "cpu")
    drv.setup()
    drv.release()
    train = drv.controls()
    assert set(train) == {"bf16", "half_batch"}
    rd = _render_driver()
    rd.release()
    render = rd.controls()
    for name, lim in limits.items():
        for got in (train if name.endswith(".train") else render).values():
            assert any(not (got[k] <= lim[k]["limit"]) for k in lim), got


def test_a_nan_reading_is_never_passed_over():
    prog = {"loss": [0.5, 0.4, 0.3], "accum": 1.0, "denom": 2.0,
            "grad": {"xyz": 1.0, "scaling": float("nan"), "opacity": 2.0},
            "change": {"xyz": 1.0, "scaling": 1.0, "opacity": float("nan")}}
    ref = {"loss": [0.5, 0.4, 0.3], "accum": 1.0, "denom": 2.0,
           "grad": {"xyz": 1.0, "scaling": 1.0, "opacity": 2.0},
           "change": {"xyz": 1.0, "scaling": 1.0, "opacity": 1.0}}
    got = train_driver.compare(prog, ref)
    assert got["loss_gap"] == 0.0 and got["stats_gap"] == 0.0
    assert math.isnan(got["grad_gap"]) and math.isnan(got["change_gap"])
    assert math.isnan(drivers.worst([1.0, float("nan")]))


def test_the_pixel_gap_passes_over_only_its_share():
    """At 10,000 pixels the 0.01 % spared is one pixel: a second pixel off
    counts, and so does a NaN anywhere."""
    ref = torch.full((3, 100, 100), 0.5)
    levels = drivers.to_levels(ref)
    base = drivers.level_gap(levels, ref)
    assert base <= 0.5
    off = levels.clone()
    off[3, 4, 1] = 0
    assert drivers.level_gap(off, ref) > 100
    assert drivers.level_gap(off, ref, 1e-4) == base
    off[7, 9, 2] = 200
    assert drivers.level_gap(off, ref, 1e-4) == pytest.approx(200.5 - 127.5)
    bad = ref.clone()
    bad[0, 50, 50] = math.nan
    assert math.isnan(drivers.level_gap(levels, bad, 1e-4))


def test_inputs_are_made_again_alike():
    cfg = tiny_config("m360-mean-3m")
    a = inputs.leaf(cfg, SEED, "scaling", "cpu")
    assert torch.equal(a, inputs.leaf(cfg, SEED, "scaling", "cpu"))
    assert not torch.equal(a, inputs.leaf(cfg, SEED + 1, "scaling", "cpu"))
    assert torch.equal(inputs.target(cfg, SEED, 3, "cpu"),
                       inputs.target(cfg, SEED, 3, "cpu"))
