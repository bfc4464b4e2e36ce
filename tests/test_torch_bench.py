"""The port's bench entry (``python -m priordepth_gaussiansplatting_torch.
bench``) on the CPU at a toy size, through the kernels' plain versions:
its last line has ``bench.py``'s keys and metric wording, its capacities
follow ``bench.py``'s rule, and its loss and gradients match the same
expression through the JAX package's Pallas rasterizer in interpret mode
on the same numpy-seeded Gaussians. Tolerances: loss rel 1e-5; gradients
atol 3e-4 max|g| and rtol 2e-3 against JAX's exact gradients
(tests/test_pallas_vs_oracle.py's rule)."""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import bench
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.core import transforms as jtr
from priordepth_gaussiansplatting_tpu.ops import binning as jbin
from priordepth_gaussiansplatting_tpu.ops import projection as jproj
from priordepth_gaussiansplatting_tpu.ops import rasterize_pallas as rp
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)
N, W, H = 2000, 64, 48
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]


def toy_inputs():
    g = PT.random_gaussians(0, N, extent=1.0, scale_range=(0.001, 0.004))
    target = np.random.default_rng(1).random((3, H, W)).astype(np.float32)
    return g, target


def jax_project(p, cam):
    return jproj.project_gaussians(
        p["means"], jtr.scaling_rotation_to_cov3d(p["scales"], p["quats"]),
        p["opacities"], p["sh"], 3, cam.world_view, cam.full_proj,
        cam.cam_center, W, H, cam.tan_fovx, cam.tan_fovy, antialiasing=True)


def jax_bench(g, target):
    """bench.py's probe, capacities, loss and gradient, in interpret mode
    with exact gradients."""
    cam = JT.look_at_camera(bench.EYE, width=W, height=H)
    params = {k: jnp.asarray(v) for k, v in g.items()}
    _, aux = jbin.bin_sorted_pairs(jax_project(params, cam), W, H,
                                   rp.default_pair_capacity(N),
                                   interpret=True)
    p_cap = rp.round_capacity(int(int(aux["num_rect"]) * 1.05))
    v_cap = rp.round_capacity(int(int(aux["num_valid"]) * 1.05))

    def loss_fn(p):
        out = rp.rasterize(jax_project(p, cam), jnp.zeros(3), W, H,
                           pair_capacity=p_cap, valid_capacity=v_cap,
                           interpret=True, exact_grads=True)
        return (jnp.mean((out["render"] - target) ** 2)
                + 0.01 * jnp.mean(out["invdepth"]))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return dict(num_rect=int(aux["num_rect"]), num_valid=int(aux["num_valid"]),
                p_cap=p_cap, v_cap=v_cap, loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()})


def test_run_and_its_line():
    res = bench.run(N, W, H, 2, "cpu")
    assert res["device"] == "cpu" and res["overflow"] == 0
    assert 0 < res["num_valid"] <= res["num_rect"]
    assert (res["p_cap"], res["v_cap"]) == bench.capacities(
        res["num_rect"], res["num_valid"])
    assert res["ms_per_step"] > 0 and res["rays_per_s"] > 0
    # on the CPU the wrappers take their plain versions: no launches
    assert res["steps"] == 2 + 5 and res["launches"] == {}
    line = json.loads(json.dumps(bench.result_line(N, W, H,
                                                   res["rays_per_s"])))
    assert list(line) == BENCH_KEYS
    assert re.fullmatch(r"rays/s fwd\+bwd, \d+k gaussians @\d+x\d+, 1 chip",
                        line["metric"])
    assert line["metric"] == "rays/s fwd+bwd, 2k gaussians @64x48, 1 chip"
    assert line["unit"] == "rays/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 30e6, 4)
    # bench.py's full-size wording
    assert bench.metric(1_000_000, 1600, 1066) == (
        "rays/s fwd+bwd, 1000k gaussians @1600x1066, 1 chip")


def test_capacities_follow_bench_py():
    for num_rect, num_valid in [(0, 0), (3900, 3000), (4000, 3901),
                                (123_457, 99_999), (2_400_000, 1_900_000)]:
        assert bench.capacities(num_rect, num_valid) == (
            rp.round_capacity(int(num_rect * 1.05)),
            rp.round_capacity(int(num_valid * 1.05)))


def test_loss_and_gradients_match_jax():
    g, target = toy_inputs()
    want = jax_bench(g, target)
    cam = PT.look_at_camera(bench.EYE, width=W, height=H, device="cpu")
    params = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    res = bench.run(N, W, H, 1, "cpu")
    # the probe's counts and so the capacities are JAX's
    assert {k: res[k] for k in ("num_rect", "num_valid", "p_cap", "v_cap")} \
        == {k: want[k] for k in ("num_rect", "num_valid", "p_cap", "v_cap")}
    loss, grads, out = bench.loss_and_grads(
        params, cam, torch.from_numpy(target), W, H, res["p_cap"],
        res["v_cap"])
    assert int(out["overflow"]) == 0
    assert float(loss) == pytest.approx(want["loss"], rel=1e-5)
    assert set(grads) == set(want["grads"]) == set(g)
    for name, got in grads.items():
        ref = want["grads"][name]
        assert np.isfinite(got.numpy()).all(), name
        assert float(np.abs(ref).max()) > 0, name
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=3e-4 * float(np.abs(ref).max()),
                                   rtol=2e-3, err_msg=name)
