"""The port's train CLI over two data ranks on the CPU: with ``--n_data 2
--data_device cpu`` it starts two gloo ranks itself
(``parallel/mesh.py::spawn``, here under a 120 s timeout), trains
tests/test_torch_mesh_trainer.py's scene, and only rank 0 writes the
artifacts and prints; the render CLI renders the snapshot. And the mesh
trainer on a world of one equals the single-rank trainer bit for bit
through densify rounds when both take the same split draws; and under a
process group that the environment names (as torchrun sets it), each
process joins it as one rank."""

import collections
import json
import os
import subprocess
import sys

import torch

from priordepth_gaussiansplatting_torch import render as render_cli
from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
from priordepth_gaussiansplatting_torch.train import __main__ as train_cli
from priordepth_gaussiansplatting_torch.utils import testing as T
from test_torch_mesh_trainer import make_scene, port_trainer

torch.set_num_threads(2)
ITERS = 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _losses_with_draws(rank, world, root, out, iters):
    """Per-iteration losses and active rows of a trainer whose densify
    rounds take split draws from a generator seeded 0; on a world of one
    mesh when called by spawn, else on one rank."""
    if world:
        torch.set_num_threads(1)
    mesh = pmesh.Mesh(1, 1, device="cpu") if world else None
    tr = port_trainer(root, out, mesh, iters)
    g = torch.Generator().manual_seed(0)
    tr.noise_source = lambda: torch.randn((2, tr.state.capacity, 3),
                                          generator=g)
    rows = []
    tr.train(iterations=iters, test_iterations=(), save_iterations=(),
             on_iteration=lambda t, it, m: rows.append(
                 (float(m["loss"]), int(m["n_active"]))))
    return rows


def test_world_of_one_trainer_equals_the_single_rank_trainer(tmp_path):
    root = make_scene(str(tmp_path / "scene"))
    iters = 8  # densify rounds at 3 and 6
    want = _losses_with_draws(0, 0, root, str(tmp_path / "single"), iters)
    (got,) = pmesh.spawn(1, _losses_with_draws, root, str(tmp_path / "mesh"),
                         iters, backend="gloo", store_dir=str(tmp_path),
                         timeout=120.0)
    assert got == want
    assert len({n for _, n in want}) >= 2  # the rounds changed the store


def test_train_cli_two_data_ranks(tmp_path, monkeypatch, capfd):
    root = make_scene(str(tmp_path / "scene"))
    model = str(tmp_path / "model")
    for var in train_cli.GROUP_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(train_cli, "SPAWN_TIMEOUT", 120.0)
    result = train_cli.main([
        "-s", root, "-m", model, "-w", "--data_device", "cpu",
        "--n_data", "2", "--disable_viewer", "--quiet",
        "--noise_injection_iter", "0", "--floating_prune_iter", "0",
        "--init_capacity", "512", "--iterations", str(ITERS),
        "--test_iterations", str(ITERS), "--save_iterations", str(ITERS),
        "--checkpoint_iterations", str(ITERS)])
    assert result["iterations_run"] == ITERS and result["skipped"] == 0
    assert result["n_active"] >= 128
    out = capfd.readouterr().out
    assert out.count("Multi-chip mesh: data=2 gauss=1 over 2 devices "
                     "(gloo)") == 1
    assert out.count("Training complete: ") == 1
    assert out.count("Output folder: ") == 1
    for rel in ("cfg_args", "events.jsonl", "exposure.json", "input.ply",
                "cameras.json", f"chkpnt{ITERS}.pkl",
                f"point_cloud/iteration_{ITERS}/point_cloud.ply"):
        assert os.path.exists(os.path.join(model, rel)), rel
    # one writer: every (tag, step) of the event log appears once, but
    # total_points, which the metrics and the report both log (as the
    # reference's train.py does)
    with open(os.path.join(model, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    keys = collections.Counter((e["tag"], e["step"]) for e in events)
    assert keys[("train_loss_patches/total_loss", ITERS)] == 1
    assert keys[("train/loss_viewpoint - psnr", ITERS)] == 1
    assert keys.pop(("total_points", ITERS)) == 2
    assert max(keys.values()) == 1, keys.most_common(3)

    render_cli.main(["-m", model, "--data_device", "cpu"])
    rdir = os.path.join(model, "train", f"ours_{ITERS}", "renders")
    assert len(os.listdir(rdir)) == 4


def test_train_cli_joins_the_environments_group(tmp_path):
    """Two processes with torchrun's variables (a TCP store on localhost)
    train over (1, 2) as one group: rank 0 writes and prints."""
    root = make_scene(str(tmp_path / "scene"))
    model = str(tmp_path / "model")
    port = T.free_port_below_ephemeral("localhost")
    env = {k: v for k, v in os.environ.items()
           if k not in train_cli.GROUP_ENV}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="localhost",
               MASTER_PORT=str(port), WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "priordepth_gaussiansplatting_torch.train",
         "-s", root, "-m", model, "-w", "--data_device", "cpu",
         "--n_gauss", "2", "--disable_viewer", "--quiet",
         "--noise_injection_iter", "0", "--floating_prune_iter", "0",
         "--init_capacity", "512", "--iterations", "4",
         "--test_iterations", "4", "--save_iterations", "4"],
        cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:]
                                                     for o in outs]
    assert outs[0][0].count("Training complete: ") == 1
    assert "Multi-chip mesh: data=1 gauss=2 over 2 devices" in outs[0][0]
    assert "Training complete" not in outs[1][0]
    assert os.path.exists(os.path.join(
        model, "point_cloud", "iteration_4", "point_cloud.ply"))


def test_a_fresh_scenes_point_cloud_is_written_whole(tmp_path, monkeypatch):
    """The ranks the CLI starts load a fresh scene at once, and each one
    that finds no initial point cloud writes it: the file appears under
    its name only whole (a temporary file renamed into place), so no rank
    reads a part of another's write. COLMAP (points3D.bin converted) and
    Blender (random points) scenes."""
    from priordepth_gaussiansplatting_torch.data import dataset
    from test_data import _make_blender_scene
    from test_torch_trainer import make_scene as make_colmap_scene
    colmap = make_colmap_scene(str(tmp_path / "colmap"))
    blender = str(tmp_path / "blender")
    _make_blender_scene(blender, n_frames=2, size=16)
    store, writes = dataset.ply_io.store_point_ply, []

    def watched(path, xyz, rgb):
        final = path[:path.index(".ply") + 4]
        assert not os.path.exists(final), final
        writes.append((path, final))
        store(path, xyz, rgb)
    monkeypatch.setattr(dataset.ply_io, "store_point_ply", watched)
    for root, name in ((colmap, "sparse/0/points3D.ply"),
                       (blender, "points3d.ply")):
        scene = dataset.Scene(root, device="cpu")
        final = os.path.join(root, name)
        assert writes[-1][1] == final and writes[-1][0] != final
        assert os.path.exists(final)
        assert not [f for f in os.listdir(os.path.dirname(final))
                    if f.endswith(".tmp")]
        assert scene.info.point_cloud[0].shape[0] > 0
    assert len(writes) == 2
