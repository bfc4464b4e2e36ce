"""Training checkpoints and snapshots of the port against the JAX package's
``train/checkpoint.py``: a checkpoint written by either package, full or
compact, loads in the other with every array equal; ``maybe_grow`` grows
the store and the Adam moments as JAX's does; the snapshot's PLY and
``exposure.json`` are byte for byte JAX's."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.train import checkpoint as pckpt
from priordepth_gaussiansplatting_torch.train import optim as poptim
from priordepth_gaussiansplatting_tpu.models import gaussians as jgm
from priordepth_gaussiansplatting_tpu.train import checkpoint as jckpt
from priordepth_gaussiansplatting_tpu.train import optim as joptim

torch.set_num_threads(2)
FIELDS = interop.PARAM_FIELDS
STATS = ("max_radii2d", "xyz_gradient_accum", "denom")
C = 64


def jax_state(n_active=40, seed=0, dead_every=5):
    """A JAX training state with random parameters, statistics and Adam
    moments, its first `n_active` rows live but every `dead_every`-th."""
    rng = np.random.default_rng(seed)
    shapes = {"xyz": (C, 3), "features_dc": (C, 3), "features_rest": (C, 45),
              "scaling": (C, 3), "rotation": (C, 4), "opacity": (C, 1),
              "exposure": (3, 3, 4)}

    def tree():
        return jgm.GaussianParams(**{
            k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()})
    active = np.arange(C) < n_active
    active[:n_active:dead_every] = False
    state = jgm.GaussianState(
        params=tree(), active=jnp.asarray(active),
        max_radii2d=jnp.asarray(rng.random(C).astype(np.float32)),
        xyz_gradient_accum=jnp.asarray(rng.random(C).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 9, C).astype(np.float32)),
        active_sh_degree=jnp.asarray(2, jnp.int32), spatial_lr_scale=1.75,
        max_sh_degree=3)
    opt = joptim.AdamState(mu=tree(), nu=tree(),
                           count=jnp.asarray(7, jnp.int32))
    return state, opt


def assert_same(state, opt, state_j, opt_j):
    """Port (state, opt) equal to JAX's."""
    got = interop.gaussian_state_to_numpy(state)
    for k in FIELDS + ("active",) + STATS:
        want = (state_j.params if k in FIELDS else state_j)
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert state.active_sh_degree == int(state_j.active_sh_degree)
    assert state.max_sh_degree == state_j.max_sh_degree
    assert state.spatial_lr_scale == state_j.spatial_lr_scale
    o = interop.adam_state_to_numpy(opt)
    for part in ("mu", "nu"):
        for k in FIELDS:
            want = np.asarray(getattr(getattr(opt_j, part), k))
            np.testing.assert_array_equal(o[part][k], want,
                                          err_msg=f"{part}.{k}")
    assert o["count"] == int(opt_j.count)


@pytest.mark.parametrize("compact", [False, True])
def test_checkpoint_round_trip_with_jax(tmp_path, compact):
    state_j, opt_j = jax_state()
    path_j = str(tmp_path / "jax.pkl")
    jckpt.save_checkpoint(path_j, state_j, opt_j, 1234, compact=compact)

    # JAX -> port: what JAX's own loader makes of the file (a compact
    # checkpoint comes back with its live rows first, then padding).
    want_j, want_opt_j, _ = jckpt.load_checkpoint(path_j)
    state, opt, it = pckpt.load_checkpoint(path_j, device="cpu")
    assert it == 1234 and state.capacity == C
    assert_same(state, opt, want_j, want_opt_j)
    if compact:
        n = int(np.asarray(state_j.active).sum())
        live = np.asarray(state_j.active)
        np.testing.assert_array_equal(state.params.xyz[:n].numpy(),
                                      np.asarray(state_j.params.xyz)[live])
        assert not state.active[n:].any()
        assert torch.isfinite(state.get_rotation()).all()
    else:
        assert_same(state, opt, state_j, opt_j)

    # port -> JAX, from what the port loaded
    path_p = str(tmp_path / "port.pkl")
    pckpt.save_checkpoint(path_p, state, opt, it, compact=compact)
    back_j, back_opt_j, it_j = jckpt.load_checkpoint(path_p)
    assert it_j == 1234 and back_j.capacity == C
    assert_same(state, opt, back_j, back_opt_j)


def test_port_checkpoint_has_the_jax_layout(tmp_path):
    """The same keys, shapes and dtypes in the pickled payload."""
    state_j, opt_j = jax_state(seed=3)
    jckpt.save_checkpoint(str(tmp_path / "j.pkl"), state_j, opt_j, 9)
    state, opt, _ = pckpt.load_checkpoint(str(tmp_path / "j.pkl"),
                                          device="cpu")
    pckpt.save_checkpoint(str(tmp_path / "p.pkl"), state, opt, 9)
    with open(tmp_path / "j.pkl", "rb") as f:
        a = pickle.load(f)
    with open(tmp_path / "p.pkl", "rb") as f:
        b = pickle.load(f)

    def layout(d):
        if isinstance(d, dict):
            return {k: layout(v) for k, v in d.items()}
        if isinstance(d, np.ndarray):
            return (d.shape, d.dtype.str)
        return type(d).__name__
    assert layout(a) == layout(b)


def test_maybe_grow_matches_jax():
    state_j, opt_j = jax_state(n_active=C, dead_every=16)  # 60 of 64 live
    state = interop.gaussian_state_from_numpy(
        {k: np.asarray(getattr(state_j.params, k)) for k in FIELDS},
        np.asarray(state_j.active), 2, 3, device="cpu",
        spatial_lr_scale=1.75,
        **{k: np.asarray(getattr(state_j, k)) for k in STATS})
    opt = interop.adam_state_from_numpy(
        {k: np.asarray(getattr(opt_j.mu, k)) for k in FIELDS},
        {k: np.asarray(getattr(opt_j.nu, k)) for k in FIELDS}, 7,
        device="cpu")
    grown_j, grown_opt_j, grew_j = jckpt.maybe_grow(state_j, opt_j)
    grown, grown_opt, grew = pckpt.maybe_grow(state, opt)
    assert grew and grew_j and grown.capacity == grown_j.capacity == 2 * C
    assert_same(grown, grown_opt, grown_j, grown_opt_j)
    # below the threshold nothing changes
    small, _, grew = pckpt.maybe_grow(grown, grown_opt)
    _, _, grew_j = jckpt.maybe_grow(grown_j, grown_opt_j)
    assert not grew and not grew_j and small is grown


def test_snapshot_and_exposure_json_match_jax(tmp_path):
    state_j, _ = jax_state(seed=5)
    state = interop.gaussian_state_from_numpy(
        {k: np.asarray(getattr(state_j.params, k)) for k in FIELDS},
        np.asarray(state_j.active), 2, 3, device="cpu")
    names = {"b.png": 0, "a.png": 2, "c.png": 1, "gone.png": 7}
    jckpt.save_model_snapshot(str(tmp_path / "jax"), 30, state_j,
                              image_names=names)
    pckpt.save_model_snapshot(str(tmp_path / "port"), 30, state,
                              image_names=names)
    for rel in ("exposure.json",
                os.path.join("point_cloud", "iteration_30",
                             "point_cloud.ply")):
        with open(tmp_path / "jax" / rel, "rb") as f:
            want = f.read()
        with open(tmp_path / "port" / rel, "rb") as f:
            assert f.read() == want, rel
    # without image names no exposure.json, as in JAX
    pckpt.save_model_snapshot(str(tmp_path / "bare"), 1, state)
    assert not os.path.exists(tmp_path / "bare" / "exposure.json")
    loaded = pckpt.load_model_snapshot(str(tmp_path / "port"), device="cpu")
    assert int(loaded.num_active) == int(np.asarray(state_j.active).sum())
    assert isinstance(poptim.init_adam(loaded.params), poptim.AdamState)
