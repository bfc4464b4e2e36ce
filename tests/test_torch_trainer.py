"""The port's single-rank ``Trainer`` against the JAX package's ``Trainer``
on a 64x64 raycast scene from ``tools/make_synthetic_scene.py`` (3 views,
200 sparse points, view 0 held out), with the same seed, so the
same camera order, and random backgrounds off. Both run their dense oracle
on the CPU. The port's densify rounds take the split draws the JAX trainer
drew from its key chain (``jax.random.normal(k, (2, capacity, 3))``).

12 iterations cover densify rounds at 5 (no size threshold) and 10 (after
the opacity reset at 7); then both jump to iteration 998 and run to 1001,
which bumps the SH degree at 1000 and densifies there. Tolerances: per
iteration loss within rtol 1e-4 (f32 sums in another order, carried
through Adam), ``n_active`` equal, report PSNR within 1e-3 dB. The capacity
ladder and the skip guard make the same decisions as JAX's on scripted
metric sequences."""

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
from priordepth_gaussiansplatting_tpu.data import dataset as jdata
from priordepth_gaussiansplatting_tpu.train import trainer as jtrainer
from priordepth_gaussiansplatting_tpu.utils import config as jcfg

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
PSNR_ATOL = 1e-3
OPT = dict(iterations=12, densify_from_iter=2, densification_interval=5,
           opacity_reset_interval=7, densify_grad_threshold=5e-5,
           noise_injection_iter=0, floating_prune_iter=0)


def make_scene(out: str, size: int = 64, views: int = 3, points: int = 200):
    """The repo's raycast scene generator, called in-process."""
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_scene", os.path.join(REPO, "tools",
                                             "make_synthetic_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(out, size, views, n_points=points)
    return out


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene")))


def trainers(scene_dir, **opt):
    opt = dict(OPT, **opt)
    jt = jtrainer.Trainer(
        jcfg.ModelConfig(source_path=scene_dir, eval=True),
        jcfg.OptimizationConfig(**opt), jcfg.PipelineConfig(),
        jdata.Scene(scene_dir, eval_split=True, seed=0), seed=0, quiet=True)
    pt = ptrainer.Trainer(
        pcfg.ModelConfig(source_path=scene_dir, eval=True),
        pcfg.OptimizationConfig(**opt), pcfg.PipelineConfig(),
        pdata.Scene(scene_dir, eval_split=True, seed=0, device="cpu"),
        seed=0, quiet=True, device="cpu")
    return jt, pt


def recorder(log):
    def on_iteration(tr, it, metrics):
        log.append((it, float(metrics["loss"]), int(metrics["n_active"]),
                    int(metrics["skipped"])))
    return on_iteration


def test_trainer_follows_jax(scene_dir):
    jt, pt = trainers(scene_dir)
    assert ([c.image_name for c in jt.scene.train_cameras]
            == [c.image_name for c in pt.scene.train_cameras])
    # JAX's densify draws, recorded as it makes them, feed the port's.
    noises = []
    jax_densify = jt.fns.densify

    def densify(state, opt_state, key, **kw):
        noises.append(np.asarray(jax.random.normal(key,
                                                   (2, state.capacity, 3))))
        return jax_densify(state, opt_state, key, **kw)
    jt.fns = dataclasses.replace(jt.fns, densify=densify)
    pt.noise_source = lambda: torch.tensor(noises.pop(0))

    logs = {"jax": [], "port": []}
    for tr, name in ((jt, "jax"), (pt, "port")):
        tr.train(test_iterations=(), save_iterations=(),
                 on_iteration=recorder(logs[name]))
    # ... then the SH bump at 1000, with a densify round there too.
    for tr, name in ((jt, "jax"), (pt, "port")):
        tr.iteration = 998
        tr.train(iterations=1001, test_iterations=(), save_iterations=(),
                 on_iteration=recorder(logs[name]))
        assert int(tr.state.active_sh_degree) == 1
    assert not noises

    its = [x[0] for x in logs["jax"]]
    assert its == list(range(1, 13)) + [999, 1000, 1001]
    assert [x[0] for x in logs["port"]] == its
    want, got = np.array(logs["jax"]), np.array(logs["port"])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    assert not got[:, 3].any() and not want[:, 3].any()
    # the densify rounds changed the store
    assert len(set(want[:, 2])) >= 3
    assert pt.state.capacity == jt.state.capacity
    assert abs(pt.ema_loss - jt.ema_loss) <= LOSS_RTOL * jt.ema_loss

    rep_j, rep_p = jt.report(1001), pt.report(1001)
    assert set(rep_j) == set(rep_p) == {"test", "train"}
    for split in rep_j:
        assert abs(rep_p[split]["psnr"] - rep_j[split]["psnr"]) <= PSNR_ATOL
        assert abs(rep_p[split]["l1"] - rep_j[split]["l1"]) <= 1e-5


# (num_pairs, overflow) every 100 iterations.
LADDER = [(3000, 0), (50_000, 0), (20_000, 0), (60_000, 0), (12_000, 0),
          (12_000, 0), (40_000, 9000), (100, 0)]


@pytest.mark.parametrize("pin", [None, 65_536])
def test_pair_capacity_ladder_matches_jax(scene_dir, pin):
    jt, pt = trainers(scene_dir)
    for tr in (jt, pt):
        tr._pin_pair_capacity = tr.pair_capacity = pin
    seen = []
    for i, (pairs, ov) in enumerate(LADDER):
        for tr in (jt, pt):
            tr.iteration = 100 * (i + 1)
            tr._adapt_pair_capacity(pairs, ov)
        assert pt.pair_capacity == jt.pair_capacity, (i, pairs, ov)
        seen.append(pt.pair_capacity)
    if pin is None:
        assert len(set(seen)) >= 3
    else:
        assert set(seen) == {pin}


# (skipped, overflow, loss) per iteration.
SKIPS = ([(1, 0, float("nan"))] * 3 + [(0, 0, 0.1)]
         + [(1, 500, 0.2)] * 26 + [(0, 0, 0.1)] * 2)


def test_skip_guard_matches_jax(scene_dir, capsys):
    jt, pt = trainers(scene_dir)
    for it, (sk, ov, loss) in enumerate(SKIPS, 1):
        for tr in (jt, pt):
            tr._observe_skip(it, sk, ov, loss)
        assert (pt.consecutive_skips, pt.total_skips, pt.pair_capacity) == \
            (jt.consecutive_skips, jt.total_skips, jt.pair_capacity), it
    # the overflow run grew the capacity once
    assert pt.pair_capacity is not None and pt.total_skips == 29
    out = capsys.readouterr().out
    assert out.count("auto-grown") == 2

    jt, pt = trainers(scene_dir)
    for tr in (jt, pt):
        with pytest.raises(RuntimeError, match="consecutive updates"):
            for it in range(1, 30):
                tr._observe_skip(it, 1, 0, float("nan"))
        assert tr.consecutive_skips == 25
