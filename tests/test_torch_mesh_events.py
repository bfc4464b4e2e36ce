"""The thesis events on the port's ``Trainer(mesh=...)`` (the counterpart of
tests/test_parallel.py::test_thesis_events_under_gauss_sharding), on the
CPU: a (1, 2) grid of gloo ranks started by ``parallel/mesh.py::spawn``
(120 s timeout) on tests/test_torch_trainer_events.py's scene with its
inverse-depth priors. No densify round runs, so the grid's store follows
the single-rank trainer's: the injection at iteration 2, the prune at 3,
and one more step at 4. Every rank must end with the same store (bit for
bit), and with the single-rank port trainer's active count after each
event; each rank records every rank's count."""

import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch.data import dataset as pdata
from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
from priordepth_gaussiansplatting_torch.train import trainer as ptrainer
from priordepth_gaussiansplatting_torch.utils import config as pcfg
from test_torch_trainer import make_scene
from test_torch_trainer_events import synthetic_tool

torch.set_num_threads(2)
SPAWN_TIMEOUT = 120.0
ITERS = 4
OPT = dict(iterations=ITERS, densify_from_iter=100, noise_injection_iter=2,
           floating_prune_iter=3)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from priordepth_gaussiansplatting_torch.utils import testing as PT
    scene = make_scene(str(tmp_path_factory.mktemp("events")))
    PT.write_depth_priors(scene, 64, 3, synthetic_tool())
    return scene


def port_trainer(root, mesh=None):
    return ptrainer.Trainer(
        pcfg.ModelConfig(source_path=root, eval=True, depths="depths"),
        pcfg.OptimizationConfig(**OPT), pcfg.PipelineConfig(),
        pdata.Scene(root, depths="depths", eval_split=True, seed=0,
                    device="cpu"),
        seed=0, quiet=True, device="cpu", mesh=mesh)


def _rank_main(rank, world, root):
    """What each rank runs (module level, so that spawn can import it)."""
    torch.set_num_threads(1)
    tr = port_trainer(root, pmesh.Mesh(1, 2, device="cpu"))
    losses = []
    result = tr.train(test_iterations=(), save_iterations=(),
                      on_iteration=lambda t, it, m: losses.append(
                          float(m["loss"])))
    state, opt_state = tr.gathered()
    return dict(events=result["events"], losses=losses,
                active=state.active.numpy(), xyz=state.params.xyz.numpy(),
                mu=opt_state.mu.xyz.numpy(), n_active=result["n_active"])


def test_thesis_events_on_a_mesh(scene_dir, tmp_path):
    results = pmesh.spawn(2, _rank_main, scene_dir, backend="gloo",
                          store_dir=str(tmp_path), timeout=SPAWN_TIMEOUT)
    single = port_trainer(scene_dir).train(test_iterations=(),
                                           save_iterations=())
    want = [(e["event"], e["iteration"], e["n_active"])
            for e in single["events"]]
    assert [w[:2] for w in want] == [("inject", 2), ("prune", 3)]
    assert want[0][2] == single["events"][0]["n_active_before"] + 6
    assert single["events"][1]["deleted"] >= 1
    for got in results:
        assert [(e["event"], e["iteration"], e["n_active"])
                for e in got["events"]] == want
        for e in got["events"]:
            assert e["n_active_by_rank"] == [e["n_active"]] * 2
        for key in ("active", "xyz", "mu"):
            np.testing.assert_array_equal(got[key], results[0][key])
        assert got["n_active"] == single["n_active"]
        assert len(got["losses"]) == ITERS
        assert np.isfinite(got["losses"]).all()
    # rank 0 ran the prune loop; the other rank took its store
    assert results[0]["events"][1]["deleted"] == single["events"][1][
        "deleted"]
    assert results[1]["events"][1]["views"] == 0
