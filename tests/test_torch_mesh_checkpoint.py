"""Checkpoints of the port's mesh trainer on the CPU, in gloo ranks started
by ``parallel/mesh.py::spawn`` (120 s timeout per spawn), on
tests/test_torch_mesh_trainer.py's scene: the port's counterparts of
tests/test_parallel.py's ``test_sharded_checkpoint_save_restore_continues``
and ``test_unsharded_checkpoint_restores_balanced_into_mesh``, the latter
also from a checkpoint that the JAX package's trainer wrote. A sharded
run's checkpoint is the gathered store, written once by rank 0; a restore
balances the shards' active rows to within one."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
from priordepth_gaussiansplatting_torch.train import checkpoint as pckpt
from test_torch_mesh_trainer import jax_trainer, make_scene, port_trainer

torch.set_num_threads(2)
SPAWN_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("ckpt") / "scene"))


def run(world, job, tmp_path):
    return pmesh.spawn(world, _rank_main, job, backend="gloo",
                       store_dir=str(tmp_path), timeout=SPAWN_TIMEOUT)


# --- what each rank runs (module level, so that spawn can import it) --------

def _rank_main(rank, world, job):
    torch.set_num_threads(1)
    mesh = pmesh.Mesh(job["n_data"], job["n_gauss"], device="cpu")
    return globals()[job["fn"]](mesh, job)


def _restored(mesh, job, path):
    """A fresh mesh trainer restored from `path`, trained to job["to"]:
    its shard's active rows after the restore, and how training went."""
    tr = port_trainer(job["root"], job["out"], mesh, job["to"])
    tr.restore(path)
    local = int(tr.state.num_active)
    restored = dict(iteration=tr.iteration, local_active=local,
                    n_active=tr.num_active())
    tr.train(iterations=job["to"], test_iterations=(), save_iterations=())
    return dict(restored=restored, ema_loss=tr.ema_loss,
                skips=tr.total_skips,
                xyz_finite=bool(torch.isfinite(tr.state.params.xyz).all()))


def _job_sharded_roundtrip(mesh, job):
    """Train 6 iterations (a densify round at 3), checkpoint at 6, restore
    into a new mesh trainer and train to 12."""
    tr = port_trainer(job["root"], job["first_out"], mesh, 6)
    tr.train(iterations=6, test_iterations=(), save_iterations=(),
             checkpoint_iterations=(6,))
    first = dict(ema_loss=tr.ema_loss, n_active=tr.num_active())
    dist.barrier()  # rank 0 has written the checkpoint
    path = os.path.join(job["first_out"], "chkpnt6.pkl")
    return dict(_restored(mesh, job, path), first=first,
                ckpt_exists=os.path.exists(path))


def _job_restore(mesh, job):
    return _restored(mesh, job, job["path"])


# --- the tests ---------------------------------------------------------------

def test_sharded_checkpoint_save_restore_continues(scene_root, tmp_path):
    results = run(4, dict(fn="_job_sharded_roundtrip", n_data=2, n_gauss=2,
                          root=scene_root, first_out=str(tmp_path / "a"),
                          out=str(tmp_path / "b"), to=12), tmp_path)
    path = str(tmp_path / "a" / "chkpnt6.pkl")
    state, _, it = pckpt.load_checkpoint(path, device="cpu")
    assert it == 6 and state.capacity == 512  # the gathered store
    first = results[0]["first"]
    assert int(state.num_active) == first["n_active"] != 128  # densified
    for r in results:
        assert r["ckpt_exists"] and r["first"] == first
        assert r["restored"]["iteration"] == 6
        assert r["restored"]["n_active"] == first["n_active"]
        assert r["skips"] == 0 and r["xyz_finite"]
        assert np.isfinite(r["ema_loss"])
        assert r["ema_loss"] < max(2.0 * first["ema_loss"], 0.5)
    # ranks (d, g) = divmod(rank, 2): both data rows hold the same shards,
    # and the two shards are balanced
    counts = [r["restored"]["local_active"] for r in results]
    assert counts[:2] == counts[2:]
    assert abs(counts[0] - counts[1]) <= 1, counts


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_unsharded_checkpoint_restores_balanced_into_mesh(writer, scene_root,
                                                          tmp_path):
    """A compact single-rank checkpoint (live rows packed at the front),
    written by either package, comes out balanced over four shards."""
    out = str(tmp_path / "single")
    path = os.path.join(out, "chkpnt5.pkl")
    if writer == "jax":
        tr = jax_trainer(scene_root, out, None, 5)
        tr.checkpoint_compact = True
        tr.train(iterations=5, test_iterations=(), save_iterations=(),
                 checkpoint_iterations=(5,))
    else:
        tr = port_trainer(scene_root, out, None, 5)
        tr.train(iterations=5, test_iterations=(), save_iterations=())
        pckpt.save_checkpoint(path, tr.state, tr.opt_state, 5, compact=True)
    n_active = int(tr.state.num_active)
    results = run(4, dict(fn="_job_restore", n_data=1, n_gauss=4,
                          root=scene_root, out=str(tmp_path / "mesh"),
                          path=path, to=8), tmp_path)
    counts = np.array([r["restored"]["local_active"] for r in results])
    assert counts.min() > 0, f"starved shard: {counts}"
    assert counts.max() - counts.min() <= 1, counts
    assert counts.sum() == n_active
    for r in results:
        assert r["restored"]["iteration"] == 5
        assert r["restored"]["n_active"] == n_active
        assert r["skips"] == 0 and r["xyz_finite"]
        assert np.isfinite(r["ema_loss"])
