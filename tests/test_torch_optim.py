"""The port's optimizer, densification and model store against the JAX
package's, field by field, on the same numpy-seeded state: Adam (dense and
sparse, three steps), the densification statistics, densify_and_prune with
the same split noise, reset_opacity, prune_rows, the schedules, the KNN
scale seeding, create_from_points and grow_capacity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.core import schedules as psched
from priordepth_gaussiansplatting_torch.models import densify as pdens
from priordepth_gaussiansplatting_torch.models import gaussians as pgauss
from priordepth_gaussiansplatting_torch.ops import knn as pknn
from priordepth_gaussiansplatting_torch.train import optim as poptim
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.core import schedules as jsched
from priordepth_gaussiansplatting_tpu.models import densify as jdens
from priordepth_gaussiansplatting_tpu.models import gaussians as jgauss
from priordepth_gaussiansplatting_tpu.ops import knn as jknn
from priordepth_gaussiansplatting_tpu.train import optim as joptim

torch.set_num_threads(2)
FIELDS = interop.PARAM_FIELDS
N = 200


def stored_params(seed, n=N):
    g = PT.random_gaussians(seed, n, scale_range=(0.005, 0.08))
    rng = np.random.default_rng(seed + 1)
    op = g["opacities"].copy()
    op[::9] = 0.002   # below the prune threshold
    return {
        "xyz": g["means"], "features_dc": g["sh"][:, :3],
        "features_rest": g["sh"][:, 3:], "scaling": np.log(g["scales"]),
        "rotation": g["quats"],
        "opacity": np.log(op / (1 - op)).astype(np.float32)[:, None],
        "exposure": (np.eye(3, 4, dtype=np.float32)[None]
                     + 0.01 * rng.standard_normal((2, 3, 4))).astype(
                         np.float32),
    }


def random_like(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in params.items()}


def jax_params(d):
    return jgauss.GaussianParams(**{k: jnp.asarray(d[k]) for k in FIELDS})


def port_params(d):
    return pgauss.GaussianParams(**{k: torch.from_numpy(np.array(d[k]))
                                    for k in FIELDS})


def states(seed, active, stats):
    params = stored_params(seed)
    state_j = jgauss.GaussianState(
        params=jax_params(params), active=jnp.asarray(active),
        **{k: jnp.asarray(v) for k, v in stats.items()},
        active_sh_degree=jnp.asarray(3, jnp.int32), spatial_lr_scale=2.0,
        max_sh_degree=3)
    state = interop.gaussian_state_from_numpy(
        params, active, 3, 3, device="cpu", spatial_lr_scale=2.0, **stats)
    return state_j, state


def assert_state_equal(state, state_j, atol=1e-6, what=""):
    got = interop.gaussian_state_to_numpy(state)
    want = {k: np.asarray(getattr(state_j.params, k)) for k in FIELDS}
    want["active"] = np.asarray(state_j.active)
    want.update({k: np.asarray(getattr(state_j, k))
                 for k in interop.STAT_FIELDS})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=1e-5,
                                   err_msg=f"{what} {k}")


def assert_adam_equal(opt, opt_j, atol=1e-6):
    got = interop.adam_state_to_numpy(opt)
    assert got["count"] == int(opt_j.count)
    for tree in ("mu", "nu"):
        for k in FIELDS:
            np.testing.assert_allclose(
                got[tree][k], np.asarray(getattr(getattr(opt_j, tree), k)),
                atol=atol, rtol=1e-5, err_msg=f"{tree} {k}")


@pytest.mark.parametrize("sparse", [False, True])
def test_adam_three_steps_match_jax(sparse):
    params = stored_params(3)
    vis = np.random.default_rng(0).random(N) > 0.3
    lrs = dict(xyz=3e-4, features_dc=2.5e-3, features_rest=1.25e-4,
               scaling=5e-3, rotation=1e-3, opacity=2.5e-2, exposure=1e-2)
    p_j, p = jax_params(params), port_params(params)
    opt_j = joptim.init_adam(p_j)
    opt = poptim.init_adam(p)
    for step in range(3):
        g = random_like(params, 10 + step, scale=1e-2)
        p_j, opt_j = joptim.adam_update(
            p_j, jax_params(g), opt_j,
            joptim.LearningRates(**{k: jnp.float32(v)
                                    for k, v in lrs.items()}),
            visibility=jnp.asarray(vis), sparse=sparse)
        p, opt = poptim.adam_update(
            p, port_params(g), opt, poptim.LearningRates(**lrs),
            visibility=torch.from_numpy(vis), sparse=sparse)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(p, k).numpy(),
                                   np.asarray(getattr(p_j, k)), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    assert_adam_equal(opt, opt_j)
    mask = np.arange(N) % 4 == 0
    assert_adam_equal(poptim.zero_moments_rows(opt, torch.from_numpy(mask)),
                      joptim.zero_moments_rows(opt_j, jnp.asarray(mask)))


def densify_inputs():
    rng = np.random.default_rng(21)
    active = np.arange(N) < 150
    active[::17] = False
    stats = {
        "max_radii2d": rng.integers(0, 30, N).astype(np.float32),
        "xyz_gradient_accum": (rng.random(N) * 4e-3).astype(np.float32),
        "denom": rng.integers(0, 10, N).astype(np.float32),
    }
    return active, stats


@pytest.mark.parametrize("max_screen", [0.0, 20.0])
def test_densify_and_prune_matches_jax(max_screen):
    active, stats = densify_inputs()
    state_j, state = states(5, active, stats)
    opt_j = joptim.init_adam(state_j.params)
    opt_j = joptim.AdamState(mu=jax.tree.map(jnp.ones_like, opt_j.mu),
                             nu=jax.tree.map(jnp.ones_like, opt_j.nu),
                             count=jnp.asarray(4, jnp.int32))
    opt = interop.adam_state_from_numpy(
        {k: np.ones_like(np.asarray(getattr(state_j.params, k)))
         for k in FIELDS},
        {k: np.ones_like(np.asarray(getattr(state_j.params, k)))
         for k in FIELDS}, 4, device="cpu")
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (2, N, 3)))
    new_j, opt_nj, info_j = jdens.densify_and_prune(
        state_j, opt_j, key, 2e-4, 0.005, 1.5, max_screen, percent_dense=0.01)
    new, opt_n, info = pdens.densify_and_prune(
        state, opt, 2e-4, 0.005, 1.5, max_screen, percent_dense=0.01,
        noise=torch.from_numpy(noise.copy()))
    for k in info_j:
        assert int(info[k]) == int(info_j[k]), k
    assert int(info["n_cloned"]) > 0 and int(info["n_split"]) > 0
    assert int(info["n_pruned"]) > 0
    assert_state_equal(new, new_j, atol=2e-6, what="densify")
    assert_adam_equal(opt_n, opt_nj)


def test_densify_draws_from_the_generator():
    active, stats = densify_inputs()
    _, state = states(5, active, stats)
    opt = poptim.init_adam(state.params)
    runs = [pdens.densify_and_prune(
        state, opt, 2e-4, 0.005, 1.5, 0.0,
        generator=torch.Generator().manual_seed(s))[0].params.xyz
        for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_stats_reset_opacity_and_prune_rows_match_jax():
    active, stats = densify_inputs()
    state_j, state = states(9, active, stats)
    rng = np.random.default_rng(2)
    screen = rng.standard_normal((N, 2)).astype(np.float32) * 1e-4
    radii = rng.integers(-1, 6, N).clip(0).astype(np.int32)
    got = pdens.add_densification_stats(
        state, torch.from_numpy(screen), torch.from_numpy(radii), 64, 48)
    want = jdens.add_densification_stats(
        state_j, jnp.asarray(screen), jnp.asarray(radii), 64, 48)
    assert_state_equal(got, want, what="stats")

    opt_j = joptim.init_adam(state_j.params)
    opt_j = joptim.AdamState(mu=jax.tree.map(jnp.ones_like, opt_j.mu),
                             nu=opt_j.nu, count=opt_j.count)
    opt = interop.adam_state_from_numpy(
        {k: np.ones_like(np.asarray(getattr(state_j.params, k)))
         for k in FIELDS},
        {k: np.zeros_like(np.asarray(getattr(state_j.params, k)))
         for k in FIELDS}, 0, device="cpu")
    s_j, o_j = jdens.reset_opacity(state_j, opt_j)
    s, o = pdens.reset_opacity(state, opt)
    assert_state_equal(s, s_j, what="reset_opacity")
    assert_adam_equal(o, o_j)

    mask = rng.random(N) > 0.7
    s_j, o_j, n_j = jdens.prune_rows(s_j, o_j, jnp.asarray(mask))
    s, o, n = pdens.prune_rows(s, o, torch.from_numpy(mask))
    assert int(n) == int(n_j) > 0
    assert_state_equal(s, s_j, what="prune_rows")
    assert_adam_equal(o, o_j)


def test_schedules_match_jax():
    for kw in (dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01,
                    max_steps=30_000),
               dict(lr_init=0.01, lr_final=0.001, lr_delay_steps=500,
                    lr_delay_mult=0.0, max_steps=30_000),
               dict(lr_init=0.0, lr_final=0.0)):
        for step in (-1, 0, 1, 250, 7000, 30_000, 45_000):
            got = psched.expon_lr(step, **kw)
            want = float(jsched.expon_lr(jnp.asarray(step), **kw))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (kw, step)


def test_create_from_points_and_grow_capacity_match_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.random((300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pknn.mean_knn_sq_dist(torch.from_numpy(pts), chunk=128).numpy(),
        np.asarray(jknn.mean_knn_sq_dist(jnp.asarray(pts), chunk=128)),
        rtol=1e-4, atol=1e-7)
    want = jgauss.create_from_points(pts, cols, num_images=4,
                                     spatial_lr_scale=1.7)
    got = pgauss.create_from_points(pts, cols, num_images=4,
                                    spatial_lr_scale=1.7, device="cpu")
    assert got.capacity == want.capacity == 2048
    assert got.active_sh_degree == int(want.active_sh_degree) == 0
    assert got.spatial_lr_scale == want.spatial_lr_scale
    assert_state_equal(got, want, atol=1e-5, what="create_from_points")
    assert_state_equal(pgauss.grow_capacity(got, 3000),
                       jgauss.grow_capacity(want, 3000), atol=1e-5,
                       what="grow_capacity")
    up = got.oneup_sh_degree().oneup_sh_degree()
    assert up.active_sh_degree == 2
    assert up.oneup_sh_degree().oneup_sh_degree().active_sh_degree == 3
    assert int(got.num_active) == int(want.num_active) == 300
