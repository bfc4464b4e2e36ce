"""One and three training steps of the port (plain K2, K3, K5b and K4 behind
the rasterizer's autograd Functions) against the JAX package's train step on
its dense oracle, from the same numpy-seeded state: the loss, the Adam
moments, the densification statistics and the parameters; then a densify
round and an opacity reset inside the loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.train import optim as poptim
from priordepth_gaussiansplatting_torch.train import step as pstep
from priordepth_gaussiansplatting_torch.utils import config as pcfg
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.models import gaussians as jgauss
from priordepth_gaussiansplatting_tpu.train import optim as joptim
from priordepth_gaussiansplatting_tpu.train import step as jstep
from priordepth_gaussiansplatting_tpu.utils import config as jcfg
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)
FIELDS = interop.PARAM_FIELDS
C, N_LIVE, WH = 128, 96, 64
EYE = (0.0, 0.0, -2.5)
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3


def scene():
    """96 live Gaussians in a store of 128 (every 11th behind the camera,
    the padding rows at scale 1e-6), a random target and an inverse-depth
    prior with a random mask."""
    g = PT.random_gaussians(4, C, scale_range=(0.04, 0.12))
    g["means"][::11, 2] = -6.0
    rng = np.random.default_rng(9)
    scaling = np.log(g["scales"])
    scaling[N_LIVE:] = np.log(1e-6)
    op = g["opacities"]
    params = {
        "xyz": g["means"], "features_dc": g["sh"][:, :3],
        "features_rest": g["sh"][:, 3:], "scaling": scaling,
        "rotation": g["quats"],
        "opacity": np.log(op / (1 - op)).astype(np.float32)[:, None],
        "exposure": np.eye(3, 4, dtype=np.float32)[None],
    }
    cam = dict(image=rng.random((3, WH, WH), dtype=np.float32),
               invdepth=rng.uniform(0.2, 0.6, (WH, WH)).astype(np.float32),
               depth_mask=(rng.random((WH, WH)) > 0.2).astype(np.float32))
    return params, np.arange(C) < N_LIVE, cam


def both_states(params, active):
    state_j = jgauss.GaussianState(
        params=jgauss.GaussianParams(**{k: jnp.asarray(params[k])
                                        for k in FIELDS}),
        active=jnp.asarray(active), max_radii2d=jnp.zeros(C),
        xyz_gradient_accum=jnp.zeros(C), denom=jnp.zeros(C),
        active_sh_degree=jnp.asarray(3, jnp.int32), spatial_lr_scale=1.5,
        max_sh_degree=3)
    state = interop.gaussian_state_from_numpy(
        params, active, 3, 3, device="cpu", spatial_lr_scale=1.5)
    return state_j, state


def close(got, want, what, mask=None):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL * scale,
                               rtol=GRAD_RTOL, err_msg=what)


CASES = {
    "one_step": (1, {}),
    "three_steps": (3, {}),
    "depth_feedback": (2, dict(depth_feedback=True)),
    "sparse_adam": (3, dict(optimizer_type="sparse_adam")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax_oracle(case):
    steps, extra = CASES[case]
    params, active, cam_arrays = scene()
    if not extra.get("depth_feedback"):
        cam_arrays = dict(image=cam_arrays["image"])
    cfg = dict(iterations=1000, position_lr_max_steps=1000, **extra)
    fns_j = jstep.make_train_step(jcfg.OptimizationConfig(**cfg),
                                  jcfg.PipelineConfig(backend="oracle"))
    fns = pstep.make_train_step(pcfg.OptimizationConfig(**cfg),
                                pcfg.PipelineConfig(backend="kernels"),
                                pair_capacity=1 << 14)
    cam_j = JT.look_at_camera(EYE, width=WH, height=WH, **cam_arrays)
    cam = PT.look_at_camera(EYE, width=WH, height=WH, device="cpu",
                            **cam_arrays)
    state_j, state = both_states(params, active)
    opt_j = joptim.init_adam(state_j.params)
    opt = poptim.init_adam(state.params)
    bg_j, bg = jnp.zeros(3), torch.zeros(3)

    for it in range(1, steps + 1):
        # The JAX step donates its state: hand it copies.
        state_j, opt_j, m_j = fns_j.step(
            jax.tree.map(jnp.array, state_j), jax.tree.map(jnp.array, opt_j),
            cam_j, jnp.asarray(it), jax.random.PRNGKey(it), bg_j)
        state, opt, m = fns.step(state, opt, cam, it, None, bg)
        for k in ("loss", "l1", "ssim", "depth_loss"):
            assert abs(float(m[k]) - float(m_j[k])) <= 1e-5, (it, k)
        for k in ("n_visible", "n_active", "skipped"):
            assert int(m[k]) == int(m_j[k]), (it, k)
        assert int(m["skipped"]) == 0 and int(m["overflow"]) == 0
        assert int(m["num_pairs"]) > 0
        if it == 1:
            # After one step mu = 0.1 g: the gradients themselves.
            grads = interop.adam_state_to_numpy(opt)["mu"]
            grads_j = {k: np.asarray(getattr(opt_j.mu, k)) for k in FIELDS}
    if extra.get("depth_feedback"):
        assert float(m["depth_loss"]) > 0.0

    got_opt = interop.adam_state_to_numpy(opt)
    assert got_opt["count"] == int(opt_j.count) == steps
    for k in FIELDS:
        close(grads[k], grads_j[k], f"step-1 gradient {k}")
        assert np.isfinite(got_opt["mu"][k]).all() and \
            np.isfinite(got_opt["nu"][k]).all(), k
        close(got_opt["mu"][k], np.asarray(getattr(opt_j.mu, k)), f"mu {k}")
    live = np.abs(grads["xyz"]).max(-1) > 0
    assert live.sum() > N_LIVE // 2
    assert not live[N_LIVE:].any() and not live[::11].any()

    got = interop.gaussian_state_to_numpy(state)
    for k in interop.STAT_FIELDS:
        close(got[k], np.asarray(getattr(state_j, k)), k)
    assert (got["xyz_gradient_accum"][live] > 0).all()
    # Adam's first update is +-lr wherever g != 0, so only rows whose
    # gradient is clear of zero can be held to the JAX package's.
    for k in FIELDS:
        g = np.abs(grads_j[k])
        clear = g > 1e-3 * g.max()
        np.testing.assert_allclose(got[k][clear],
                                   np.asarray(getattr(state_j.params, k))[clear],
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    assert (got["active"] == active).all()


def test_densify_and_reset_inside_the_loop():
    """Steps, one densify round, an opacity reset and two more steps on the
    port alone: the counts follow what densify reports and the later steps
    still update the moved rows."""
    params, active, cam_arrays = scene()
    cfg = pcfg.OptimizationConfig(iterations=1000, densify_grad_threshold=1e-6)
    fns = pstep.make_train_step(cfg, pcfg.PipelineConfig(backend="kernels"),
                                pair_capacity=1 << 14)
    cam = PT.look_at_camera(EYE, width=WH, height=WH, device="cpu",
                            image=cam_arrays["image"])
    _, state = both_states(params, active)
    opt = poptim.init_adam(state.params)
    for it in range(1, 3):
        state, opt, m = fns.step(state, opt, cam, it, None, torch.zeros(3))
    n_before = int(m["n_active"])
    state, opt, info = fns.densify(state, opt,
                                   generator=torch.Generator().manual_seed(0))
    assert int(info["n_cloned"]) + int(info["n_split"]) > 0
    assert int(info["n_active"]) == (n_before + int(info["n_cloned"])
                                     + int(info["n_split"])
                                     - int(info["n_pruned"]))
    assert int(state.num_active) == int(info["n_active"])
    assert float(state.xyz_gradient_accum.abs().sum()) == 0.0
    state, opt = fns.reset_opacity(state, opt)
    assert float(torch.sigmoid(state.params.opacity).max()) <= 0.01 + 1e-6
    xyz = state.params.xyz.clone()
    for it in range(3, 5):
        state, opt, m = fns.step(state, opt, cam, it, None, torch.zeros(3))
        assert int(m["skipped"]) == 0 and np.isfinite(float(m["loss"]))
    assert int(m["n_active"]) == int(info["n_active"])
    assert not torch.equal(state.params.xyz, xyz)


def test_step_skips_an_overflowed_frame():
    """A pair capacity below the frame's pairs: the step reports the
    overflow and leaves the state and the moments as they were."""
    params, active, cam_arrays = scene()
    fns = pstep.make_train_step(pcfg.OptimizationConfig(),
                                pcfg.PipelineConfig(backend="kernels"),
                                pair_capacity=64)
    cam = PT.look_at_camera(EYE, width=WH, height=WH, device="cpu",
                            image=cam_arrays["image"])
    _, state = both_states(params, active)
    opt = poptim.init_adam(state.params)
    new, new_opt, m = fns.step(state, opt, cam, 1, None, torch.zeros(3))
    assert int(m["overflow"]) > 0 and int(m["skipped"]) == 1
    for k in FIELDS:
        assert torch.equal(getattr(new.params, k), getattr(state.params, k))
        assert torch.equal(getattr(new_opt.mu, k), getattr(opt.mu, k))
    assert int(new_opt.count) == 0
    assert float(new.denom.sum()) == 0.0


def test_learning_rates_match_jax():
    cfg_j = jcfg.OptimizationConfig()
    cfg = pcfg.OptimizationConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    for it in (0, 1, 500, 29_999):
        got = pstep.learning_rates(it, cfg, 2.5)
        want = jstep.learning_rates(jnp.asarray(it), cfg_j, 2.5)
        for k in FIELDS:
            assert getattr(got, k) == pytest.approx(float(getattr(want, k)),
                                                    rel=1e-6), (it, k)
        assert pstep.depth_l1_weight(it, cfg) == pytest.approx(
            float(jstep.depth_l1_weight(jnp.asarray(it), cfg_j)), rel=1e-6)
