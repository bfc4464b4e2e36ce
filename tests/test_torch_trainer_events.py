"""The PriorDepth thesis events in the port's single-rank ``Trainer``
against the JAX package's, on the CPU: tests/test_torch_trainer.py's 64x64,
3-view raycast scene, with inverse-depth priors written into the scene as
16-bit PNGs (``utils/testing.py::write_depth_priors``) and read by both
loaders with ``depths="depths"``. The noise injection runs at iteration 6
and the floating-object prune at 9, within 12 iterations (densify rounds at
5 and 10, an opacity reset at 7). The port takes the JAX trainer's densify
and injection draws; the prune loop's RandomState comes from the camera
generator in both.

Tolerances: per-iteration loss within rtol 1e-4 (as
tests/test_torch_trainer.py), ``n_active`` equal after each event and
every iteration, the same deletions over the same views."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch.data import dataset as pdata
from priordepth_gaussiansplatting_torch.train import trainer as ptrainer
from priordepth_gaussiansplatting_torch.utils import config as pcfg
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.data import dataset as jdata
from priordepth_gaussiansplatting_tpu.train import prune as jprune
from priordepth_gaussiansplatting_tpu.train import trainer as jtrainer
from priordepth_gaussiansplatting_tpu.utils import config as jcfg
from test_torch_trainer import LOSS_RTOL, OPT, REPO, make_scene, recorder

torch.set_num_threads(2)
EVENTS = dict(OPT, noise_injection_iter=6, floating_prune_iter=9)


def synthetic_tool():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_scene", os.path.join(REPO, "tools",
                                             "make_synthetic_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    scene = make_scene(str(tmp_path_factory.mktemp("scene")))
    PT.write_depth_priors(scene, 64, 3, synthetic_tool())
    return scene


def test_priors_reach_both_loaders(scene_dir):
    js = jdata.Scene(scene_dir, depths="depths", eval_split=True, seed=0)
    ps = pdata.Scene(scene_dir, depths="depths", eval_split=True, seed=0,
                     device="cpu")
    for jc, pc in zip(js.train_cameras + js.test_cameras,
                      ps.train_cameras + ps.test_cameras):
        assert pc.depth_reliable and jc.depth_reliable
        np.testing.assert_array_equal(pc.invdepth.numpy(),
                                      np.asarray(jc.invdepth))
        assert float(pc.invdepth.max()) > 0.3  # the scene, not only sky


def test_thesis_events_follow_jax(scene_dir, monkeypatch):
    jt = jtrainer.Trainer(
        jcfg.ModelConfig(source_path=scene_dir, eval=True, depths="depths"),
        jcfg.OptimizationConfig(**EVENTS), jcfg.PipelineConfig(),
        jdata.Scene(scene_dir, depths="depths", eval_split=True, seed=0),
        seed=0, quiet=True)
    pt = ptrainer.Trainer(
        pcfg.ModelConfig(source_path=scene_dir, eval=True, depths="depths"),
        pcfg.OptimizationConfig(**EVENTS), pcfg.PipelineConfig(),
        pdata.Scene(scene_dir, depths="depths", eval_split=True, seed=0,
                    device="cpu"),
        seed=0, quiet=True, device="cpu")

    # JAX's densify and injection draws, recorded as it makes them, feed
    # the port's; its prune loop's totals are kept.
    noises, injections, loops = [], [], []
    jax_densify = jt.fns.densify

    def densify(state, opt_state, key, **kw):
        noises.append(np.asarray(jax.random.normal(key,
                                                   (2, state.capacity, 3))))
        return jax_densify(state, opt_state, key, **kw)
    jt.fns = dataclasses.replace(jt.fns, densify=densify)

    inject, prune_loop = jprune.inject_noise_gaussians, jprune.prune_loop

    def recorded_inject(state, opt_state, key, cam_extent, **kw):
        k1, k2, k3 = jax.random.split(key, 3)
        injections.append({
            "new_xy": np.array(jax.random.uniform(
                k1, (6, 2), minval=-2 * cam_extent, maxval=cam_extent)),
            "new_op": np.array(4.0 + jax.random.uniform(k2, (6, 1)) * 5.0),
            "rand_rows": np.array(jax.random.randint(
                k3, (6,), 0, state.capacity))})
        return inject(state, opt_state, key, cam_extent, **kw)

    def recorded_loop(*args, **kw):
        out = prune_loop(*args, **kw)
        loops.append(out[2])
        return out
    monkeypatch.setattr(jprune, "inject_noise_gaussians", recorded_inject)
    monkeypatch.setattr(jprune, "prune_loop", recorded_loop)
    pt.noise_source = lambda: torch.tensor(noises.pop(0))
    pt.inject_source = lambda: injections.pop(0)

    logs = {"jax": [], "port": []}
    after = {"jax": {}, "port": {}}

    def counts(name):
        def on_iteration(tr, it, metrics):
            recorder(logs[name])(tr, it, metrics)
            after[name][it] = int(tr.state.num_active)
        return on_iteration

    jt.train(test_iterations=(), save_iterations=(),
             on_iteration=counts("jax"))
    result = pt.train(test_iterations=(), save_iterations=(),
                      on_iteration=counts("port"))
    assert not noises and not injections and len(loops) == 1

    want, got = np.array(logs["jax"]), np.array(logs["port"])
    assert [x[0] for x in logs["port"]] == list(range(1, 13))
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    assert not got[:, 3].any()
    assert after["port"] == after["jax"]

    inj, prn = result["events"]
    assert (inj["event"], inj["iteration"]) == ("inject", 6)
    assert inj["n_active"] == after["jax"][6] == inj["n_active_before"] + 6
    assert (prn["event"], prn["iteration"]) == ("prune", 9)
    assert prn["n_active"] == after["jax"][9]
    assert prn["deleted"] == loops[0]["total_deleted"] >= 1
    assert (prn["views"], prn["history"]) == (loops[0]["epochs"],
                                              loops[0]["history"])
    assert prn["n_active"] == prn["n_active_before"] - prn["deleted"]
    # the oracle on the CPU: no kernel launched
    assert result["step_launches"] == {} and prn["launches"] == {}
