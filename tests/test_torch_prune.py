"""The port's ``train/prune.py`` against the JAX package's on the CPU.

Both packages get the same inputs: the state and Adam moments as numpy
arrays, cameras built from the same matrices, and the same rendered inverse
depth and radii arrays (from JAX's dense oracle, or random). Scenes: JAX's
floater scene (``tests/test_prune.py::_scene_with_floater``, rebuilt here)
and a random 4,096-row state with a random prior, rows behind the camera,
inactive rows, invisible rows and a few huge ones.

Tolerances: ``update_table``, ``FeatureTable`` and ``inject_noise_gaussians``
(fed JAX's draws) equal bit for bit; ``least_squares_fit`` within rtol 1e-5
(f32 sums in another order); ``prune_view``'s mask, count, zeroed moments
and table equal except for rows within 1e-5 (relative, in float64) of one
of the view's thresholds or of a pixel edge, which the test counts: at
most 0.1 % of the rows; ``adjust_gaussians_to_depth`` within atol 1e-5;
``prune_loop`` through each package's plain render with equal deletion
histories."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.ops import render as prender
from priordepth_gaussiansplatting_torch.train import prune as pprune
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.models import gaussians as jgm
from priordepth_gaussiansplatting_tpu.ops.render import render as jrender
from priordepth_gaussiansplatting_tpu.train import optim as joptim
from priordepth_gaussiansplatting_tpu.train import prune as jprune
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)
W = H = 64
MARGIN = 1e-5        # relative distance to a threshold that excuses a row
MAX_EXCUSED = 1e-3   # share of the rows that may be excused
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


# --- the same inputs in both packages ---------------------------------------

def floater_scene():
    """tests/test_prune.py's wall of 30 Gaussians at z = 0 and one floater
    at z = -1, in a store of 64 rows."""
    rng = np.random.RandomState(1)
    n_bg = 30
    pts = np.concatenate([
        np.concatenate([rng.uniform(-0.6, 0.6, (n_bg, 2)),
                        np.zeros((n_bg, 1))], axis=1),
        np.array([[0.0, 0.0, -1.0]])]).astype(np.float32)
    cols = np.concatenate([np.full((n_bg, 3), 0.5),
                           np.array([[1.0, 0.0, 0.0]])]).astype(np.float32)
    st = jgm.create_from_points(pts, cols, num_images=1, capacity=64)
    st = st.replace(params=st.params.replace(
        opacity=jnp.full((64, 1), 3.0), scaling=jnp.full(
            (64, 3), np.log(0.15), jnp.float32)))
    return st, n_bg


def random_scene(n: int = 4096, seed: int = 0):
    """Gaussians in front of a camera at z = -2 (some behind it, some
    inactive, a few with a scale above 50)."""
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                          rng.uniform(-1.0, 1.5, (n, 1))], 1)
    xyz[: n // 64, 2] = -2.5                      # behind the camera
    xyz[n // 64: n // 32, 2] = -2.0               # in its plane
    cols = rng.uniform(0, 1, (n, 3))
    st = jgm.create_from_points(xyz.astype(np.float32),
                                cols.astype(np.float32), num_images=1,
                                capacity=n)
    scaling = np.log(rng.uniform(0.005, 0.3, (n, 3))).astype(np.float32)
    scaling[rng.choice(n, 8, replace=False)] = np.log(60.0)
    active = rng.random(n) > 0.1
    return st.replace(params=st.params.replace(scaling=jnp.asarray(scaling)),
                      active=jnp.asarray(active))


def random_moments(st, seed: int = 3):
    rng = np.random.default_rng(seed)
    tree = {k: jnp.asarray(rng.standard_normal(np.shape(getattr(st.params, k)),
                                               dtype=np.float32))
            for k in FIELDS + ("exposure",)}
    mu = st.params.replace(**tree)
    nu = jax.tree.map(jnp.abs, mu)
    return joptim.AdamState(mu=mu, nu=nu, count=jnp.asarray(7, jnp.int32))


def to_port(st, opt):
    params = {k: np.array(getattr(st.params, k))
              for k in FIELDS + ("exposure",)}
    state = interop.gaussian_state_from_numpy(
        params, np.array(st.active), int(st.active_sh_degree),
        int(st.max_sh_degree), device="cpu")
    moments = interop.adam_state_from_numpy(
        {k: np.asarray(getattr(opt.mu, k)) for k in params},
        {k: np.asarray(getattr(opt.nu, k)) for k in params},
        int(opt.count), device="cpu")
    return state, moments


def cameras(eye=(0.0, 0.0, -2.0), target=(0.0, 0.0, 0.0), invdepth=None):
    """(JAX camera, port camera) with the same matrices and prior."""
    jc = JT.look_at_camera(eye, target=target, width=W, height=H)
    pc = PT.look_at_camera(eye, target=target, width=W, height=H,
                           device="cpu")
    if invdepth is not None:
        jc = dataclasses.replace(jc, invdepth=jnp.asarray(invdepth),
                                 depth_reliable=True)
        pc = dataclasses.replace(pc, invdepth=torch.tensor(invdepth),
                                 depth_reliable=True)
    return jc, pc


# --- the margin that excuses a row ------------------------------------------

def borderline(st, cam, inv, radii, extent, k=1.0, b=0.0):
    """Rows within MARGIN (relative, float64) of a threshold of the view:
    the pixel bounds and edges, cam_z > 0, the floating and huge tests."""
    xyz = np.asarray(st.params.xyz, np.float64)
    w2c = np.asarray(cam.world_view, np.float64)
    c = xyz @ w2c[:3, :3].T + w2c[:3, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        px = W / (2 * cam.tan_fovx) * c[:, 0] / c[:, 2] + W / 2
        py = H / (2 * cam.tan_fovy) * c[:, 1] / c[:, 2] + H / 2

    def near(a, t):
        a = np.broadcast_to(a, np.shape(a))
        scale = np.maximum(np.maximum(np.abs(a), np.abs(t)), 1e-30)
        return np.abs(a - t) <= MARGIN * scale

    edge = np.zeros(len(xyz), bool)
    for p in (px, py):
        fin = np.isfinite(p)
        edge |= fin & near(p, np.round(p))       # a pixel edge or bound
    edge |= near(c[:, 2], 0.0) | near(c[:, 2], jprune.NEAR_Z)
    xi = np.clip(np.nan_to_num(px), 0, W - 1).astype(np.int64)
    yi = np.clip(np.nan_to_num(py), 0, H - 1).astype(np.int64)
    rend = 1.0 / (np.asarray(inv, np.float64)[0][yi, xi] + jprune.EPSILON)
    mono = 1.0 / (np.asarray(cam.invdepth, np.float64)[yi, xi]
                  + jprune.EPSILON)
    s = np.exp(np.asarray(st.params.scaling, np.float64))
    nr, nm = k * rend + b, k * mono + b
    edge |= near(nm - nr, extent) | near(c[:, 2] - np.cbrt(s.prod(1)), nr)
    edge |= near(s.max(1), jprune.MAX_RADII_WORLD)
    return edge


def excused(got, want, ok):
    """The rows where `got` and `want` differ; they must all be in `ok`,
    and at most MAX_EXCUSED of the rows."""
    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    assert np.isin(diff, np.nonzero(ok)[0]).all(), diff[~np.isin(
        diff, np.nonzero(ok)[0])]
    assert len(diff) <= MAX_EXCUSED * len(ok), len(diff)
    return diff


# --- the pieces --------------------------------------------------------------

LSQ = {
    "line": lambda r: (r.random(200) * 10, None, np.ones(200, bool)),
    "masked": lambda r: (r.random(300) * 4, r.random(300) * 0.2,
                         r.random(300) > 0.4),
    "constant": lambda r: (np.ones(200), None, np.ones(200, bool)),
    "empty": lambda r: (r.random(50), None, np.zeros(50, bool)),
}


@pytest.mark.parametrize("case", sorted(LSQ))
def test_least_squares_fit_matches_jax(case):
    rng = np.random.RandomState(0)
    x, noise, mask = LSQ[case](rng)
    x = x.astype(np.float32)
    y = (2.5 * x - 1.25 + (0 if noise is None else noise)).astype(np.float32)
    kj, bj, okj = jprune.least_squares_fit(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(mask))
    kp, bp, okp = pprune.least_squares_fit(torch.tensor(x), torch.tensor(y),
                                           torch.tensor(mask))
    assert bool(okp) == bool(okj)
    np.testing.assert_allclose(float(kp), float(kj), rtol=1e-5)
    np.testing.assert_allclose(float(bp), float(bj), rtol=1e-5, atol=1e-6)


# (table size, [(rows, valid rows)] appended in turn)
TABLES = {
    "wrap": (8, [(5, "all"), (5, "all")]),
    "invalid_rows": (16, [(9, "random"), (12, "random"), (7, "none")]),
    "more_than_size": (8, [(3, "all"), (20, "all"), (13, "random")]),
}


@pytest.mark.parametrize("case", sorted(TABLES))
def test_update_table_matches_jax(case):
    size, appends = TABLES[case]
    rng = np.random.default_rng(1)
    tj, tp = (jprune.FeatureTable.empty(size),
              pprune.FeatureTable.empty(size, device="cpu"))
    for rows, which in appends:
        pairs = rng.standard_normal((rows, 2), dtype=np.float32)
        valid = {"all": np.ones(rows, bool), "none": np.zeros(rows, bool),
                 "random": rng.random(rows) > 0.5}[which]
        tj = jprune.update_table(tj, jnp.asarray(pairs), jnp.asarray(valid))
        tp = pprune.update_table(tp, torch.tensor(pairs), torch.tensor(valid))
        np.testing.assert_array_equal(tp.data.numpy(), np.asarray(tj.data))
        assert int(tp.index) == int(tj.index)
        assert int(tp.count) == int(tj.count)
        assert tp.index.dtype == tp.count.dtype == torch.int32


def test_feature_table_empty_matches_jax():
    tj, tp = jprune.FeatureTable.empty(), pprune.FeatureTable.empty(
        device="cpu")
    assert tuple(tp.data.shape) == tj.data.shape == (jprune.MAX_TABLE, 2)
    assert tp.data.dtype == torch.float32 and not tp.data.any()
    assert int(tp.index) == int(tj.index) == 0
    assert int(tp.count) == int(tj.count) == 0


def view_inputs(scene: str):
    """(JAX state, moments, cameras, rendered invdepth, radii, extent)."""
    if scene == "floater":
        st, _ = floater_scene()
        jc, pc = cameras(invdepth=np.full((H, W), 0.5, np.float32))
        out = jrender(jc, st, jnp.zeros(3), backend="oracle")
        return (st, random_moments(st), (jc, pc), np.asarray(out["invdepth"]),
                np.asarray(out["radii"]), 0.5)
    st = random_scene()
    rng = np.random.default_rng(5)
    prior = rng.uniform(0.05, 0.6, (H, W)).astype(np.float32)
    inv = rng.uniform(0.2, 0.6, (1, H, W)).astype(np.float32)
    radii = rng.integers(0, 4, st.capacity).astype(np.int32)
    return (st, random_moments(st), cameras(invdepth=prior), inv, radii, 1.0)


@pytest.mark.parametrize("use_ls", [False, True], ids=["k1b0", "lsq"])
@pytest.mark.parametrize("scene", ["floater", "random"])
def test_prune_view_matches_jax(scene, use_ls):
    st, opt, (jc, pc), inv, radii, extent = view_inputs(scene)
    ps, po = to_port(st, opt)
    table = pprune.FeatureTable.empty(1024, device="cpu")
    terms = pprune.view_terms(ps, pc, torch.tensor(inv), torch.tensor(radii))
    ps2, po2, tp, n_p = pprune.prune_view(
        ps, po, table, pc, torch.tensor(inv), torch.tensor(radii), extent,
        use_least_squares=use_ls)
    js2, jo2, tj, n_j = jprune.prune_view(  # donates its state: copies
        jax.tree.map(jnp.array, st), jax.tree.map(jnp.array, opt),
        jprune.FeatureTable.empty(1024), jc, jnp.asarray(inv),
        jnp.asarray(radii), extent, use_least_squares=use_ls)
    k, b = 1.0, 0.0
    if use_ls:
        in_tbl = np.arange(1024) < int(tj.count)
        k, b, _ = jprune.least_squares_fit(tj.data[:, 0], tj.data[:, 1],
                                           jnp.asarray(in_tbl))
        k, b = float(k), float(b)
    near = borderline(st, jc, inv, radii, extent, k, b)
    active_j = np.asarray(js2.active)
    diff = excused(ps2.active.numpy(), active_j, near)
    assert int(n_p) - int(n_j) == int((~ps2.active.numpy()[diff]).sum()
                                      - (~active_j[diff]).sum())
    if scene == "random":
        assert int(n_j) > (0 if use_ls else 100), int(n_j)
    elif not use_ls:  # the fit of one view's 31 rows spares the floater
        assert not active_j[30] and int(n_p) == int(n_j) >= 1
    keep = np.ones(st.capacity, bool)
    keep[diff] = False
    for tree_p, tree_j in ((po2.mu, jo2.mu), (po2.nu, jo2.nu)):
        for name in FIELDS:
            np.testing.assert_array_equal(
                getattr(tree_p, name).numpy()[keep],
                np.asarray(getattr(tree_j, name))[keep])
    # The table: the same valid rows, in order, the excused rows' depths
    # aside.
    valid = terms.valid.numpy()
    excused(valid, valid, near)
    assert int(tp.count) == int(tj.count) == min(int(valid.sum()), 1024)
    assert int(tp.index) == int(tj.index)
    rows = np.nonzero(valid)[0][:int(tp.count)]
    ok = ~near[rows]
    np.testing.assert_allclose(tp.data.numpy()[:len(rows)][ok],
                               np.asarray(tj.data)[:len(rows)][ok],
                               rtol=1e-5)


def inject_inputs(case: str):
    st, n_bg = floater_scene()
    act = np.asarray(st.active).copy()
    act[n_bg] = False
    if case == "three_free":
        act[:] = True
        act[[5, 40, 63]] = False
    elif case == "full":
        act[:] = True
    return st.replace(active=jnp.asarray(act))


@pytest.mark.parametrize("case", ["free", "three_free", "full"])
def test_inject_noise_gaussians_with_jax_draws(case):
    st = inject_inputs(case)
    opt = random_moments(st)
    key, extent = jax.random.PRNGKey(4), 1.3
    js, jo, jdst = jprune.inject_noise_gaussians(st, opt, key, extent)
    # JAX's draws, as inject_noise_gaussians makes them.
    k1, k2, k3 = jax.random.split(key, 3)
    draws = {"new_xy": np.array(jax.random.uniform(
                 k1, (6, 2), minval=-2 * extent, maxval=1 * extent)),
             "new_op": np.array(4.0 + jax.random.uniform(k2, (6, 1)) * 5.0),
             "rand_rows": np.array(jax.random.randint(
                 k3, (6,), 0, st.capacity))}
    ps, po = to_port(st, opt)
    ps2, po2, pdst = pprune.inject_noise_gaussians(ps, po, extent,
                                                   draws=draws)
    np.testing.assert_array_equal(pdst.numpy(), np.asarray(jdst))
    np.testing.assert_array_equal(ps2.active.numpy(), np.asarray(js.active))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(ps2.params, name).numpy(),
                                      np.asarray(getattr(js.params, name)))
        for tree_p, tree_j in ((po2.mu, jo.mu), (po2.nu, jo.nu)):
            np.testing.assert_array_equal(
                getattr(tree_p, name).numpy(),
                np.asarray(getattr(tree_j, name)))
    added = int(ps2.num_active) - int(ps.num_active)
    assert added == {"free": 6, "three_free": 3, "full": 0}[case]


def test_noise_draws_follow_the_reference_ranges():
    g = torch.Generator("cpu").manual_seed(0)
    d = pprune.noise_draws(100, 2.0, n_noise=4000, generator=g)
    assert d["new_xy"].min() >= -4.0 and d["new_xy"].max() < 2.0
    assert d["new_op"].min() >= 4.0 and d["new_op"].max() < 9.0
    assert d["rand_rows"].min() >= 0 and d["rand_rows"].max() < 100
    st = inject_inputs("free")
    ps, po = to_port(st, random_moments(st))
    ps2, _, dst = pprune.inject_noise_gaussians(ps, po, 1.0, generator=g)
    assert int(ps2.num_active) == int(ps.num_active) + 6
    assert (ps2.params.xyz[dst][:, 2] == 15.0).all()


@pytest.mark.parametrize("scene", ["floater", "random"])
def test_adjust_gaussians_to_depth_matches_jax(scene):
    st, opt, (jc, pc), inv, radii, extent = view_inputs(scene)
    ps, _ = to_port(st, opt)
    js2, n_j = jprune.adjust_gaussians_to_depth(
        jax.tree.map(jnp.array, st), jc, jnp.asarray(inv),
        jnp.asarray(radii), extent)
    ps2, n_p = pprune.adjust_gaussians_to_depth(
        ps, pc, torch.tensor(inv), torch.tensor(radii), extent)
    near = borderline(st, jc, inv, radii, 0.5 * extent)
    moved_p = (ps2.params.xyz.numpy() != np.asarray(st.params.xyz)).any(1)
    moved_j = (np.asarray(js2.params.xyz) != np.asarray(st.params.xyz)).any(1)
    diff = excused(moved_p, moved_j, near)
    assert int(n_j) > 0 and int(n_p) - int(n_j) == int(
        moved_p[diff].sum() - moved_j[diff].sum())
    keep = np.ones(st.capacity, bool)
    keep[diff] = False
    np.testing.assert_allclose(ps2.params.xyz.numpy()[keep],
                               np.asarray(js2.params.xyz)[keep], atol=1e-5)


@pytest.mark.parametrize("backend", ["oracle", "kernels"])
def test_prune_loop_matches_jax(backend):
    """tests/test_prune.py's two views through each package's plain
    render (the port's dense oracle, or its tile pipeline's plain
    versions)."""
    st, n_bg = floater_scene()
    opt = random_moments(st)
    ps, po = to_port(st, opt)
    prior = np.full((H, W), 0.5, np.float32)
    cams = [cameras(eye, invdepth=prior)
            for eye in [(-0.3, 0, -2.0), (0.3, 0, -2.0)]]

    def jfn(cam, state):
        out = jrender(cam, state, jnp.zeros(3), backend="oracle")
        return out["invdepth"], out["radii"]

    def pfn(cam, state):
        out = prender.render(cam, state, torch.zeros(3), backend=backend)
        return out["invdepth"], out["radii"]

    js2, _, info_j = jprune.prune_loop(
        jax.tree.map(jnp.array, st), jax.tree.map(jnp.array, opt),
        [c[0] for c in cams], jfn, 0.5,
        rng=np.random.RandomState(0))
    ps2, _, info_p = pprune.prune_loop(
        ps, po, [c[1] for c in cams], pfn, 0.5,
        rng=np.random.RandomState(0))
    assert info_p == info_j
    assert info_j["total_deleted"] >= 1 and info_j["epochs"] >= 2
    np.testing.assert_array_equal(ps2.active.numpy(), np.asarray(js2.active))
    assert not ps2.active[n_bg]
