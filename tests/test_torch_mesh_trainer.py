"""The port's ``Trainer(mesh=...)`` on the CPU: each rank is a gloo process
started by ``parallel/mesh.py::spawn`` (120 s timeout per spawn) and runs
its own trainer on its shard, held against the JAX package's
``Trainer(mesh=make_mesh(...))`` on the conftest's 8 CPU devices.

The scene is tests/test_parallel.py::_tiny_trainer's: a 32x32, 4-view
Blender scene from tests/test_data.py, 128 points, a store of 512 rows,
densify from iteration 2 every 3. Three iterations run up to the first
densify round (the third's round falls outside ``densify_until_iter``).
JAX's tile-sharded trainer runs its Pallas path in interpret mode with
exact gradients: its default rounds each pair's cotangent to bf16 before
the sum (a TPU economy the port does not copy), which after three Adam
steps moves a few coordinates by ~1e-4. Tolerances: per-iteration loss
rel 1e-5 and xyz after the three steps atol 1e-6 (tests/test_parallel.py's);
the metrics the host loop acts on (``Trainer._drain``: loss, l1,
n_active, num_pairs, overflow, skipped) are equal bit for bit on every
rank."""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch.data import dataset as pdata
from priordepth_gaussiansplatting_torch.data import ply as pply
from priordepth_gaussiansplatting_torch.ops import rasterize as prast
from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
from priordepth_gaussiansplatting_torch.train import trainer as ptrainer
from priordepth_gaussiansplatting_torch.utils import config as pcfg
from priordepth_gaussiansplatting_tpu.data import dataset as jdata
from priordepth_gaussiansplatting_tpu.ops import binning as jbin
from priordepth_gaussiansplatting_tpu.parallel import mesh as jmesh
from priordepth_gaussiansplatting_tpu.train import trainer as jtrainer
from priordepth_gaussiansplatting_tpu.utils import config as jcfg
from test_data import _make_blender_scene

torch.set_num_threads(2)
SPAWN_TIMEOUT = 120.0
STORE = 512
STEPS = 3


def make_scene(root: str, n_points: int = 128) -> str:
    """_tiny_trainer's scene, with its point cloud written up front (both
    packages read the same PLY)."""
    _make_blender_scene(root, n_frames=4, size=32)
    rng = np.random.default_rng(0)
    pply.store_point_ply(
        os.path.join(root, "points3d.ply"),
        rng.uniform(-1.3, 1.3, (n_points, 3)).astype(np.float32),
        rng.integers(0, 256, (n_points, 3)).astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("mesh") / "scene"))


def opt_kw(iters: int) -> dict:
    return dict(iterations=iters, position_lr_max_steps=iters,
                densify_from_iter=2, densify_until_iter=iters,
                densification_interval=3, opacity_reset_interval=1000)


def jax_trainer(root, out, mesh, iters, tile_shard=False):
    return jtrainer.Trainer(
        jcfg.ModelConfig(source_path=root, model_path=out,
                         white_background=True),
        jcfg.OptimizationConfig(**opt_kw(iters)),
        jcfg.PipelineConfig(backend="pallas" if tile_shard else "oracle"),
        jdata.Scene(root, out, white_background=True, shuffle=True),
        quiet=True, mesh=mesh, tile_shard=tile_shard, init_capacity=STORE)


def port_trainer(root, out, mesh, iters, tile_shard=False):
    writer = mesh is None or mesh.rank == 0
    return ptrainer.Trainer(
        pcfg.ModelConfig(source_path=root, model_path=out,
                         white_background=True),
        pcfg.OptimizationConfig(**opt_kw(iters)),
        pcfg.PipelineConfig(backend="kernels" if tile_shard else "oracle"),
        pdata.Scene(root, out if writer else "", white_background=True,
                    shuffle=True, device="cpu"),
        quiet=True, mesh=mesh, tile_shard=tile_shard, init_capacity=STORE,
        device="cpu")


def run(world, job, tmp_path):
    return pmesh.spawn(world, _rank_main, job, backend="gloo",
                       store_dir=str(tmp_path), timeout=SPAWN_TIMEOUT)


# --- what each rank runs (module level, so that spawn can import it) --------

def _rank_main(rank, world, job):
    torch.set_num_threads(1)
    mesh = pmesh.Mesh(job["n_data"], job["n_gauss"], device="cpu")
    return globals()[job["fn"]](mesh, job)


def _job_train(mesh, job):
    """STEPS iterations; per iteration the loss and the metrics vector the
    host loop drains, then the gathered xyz and how often this rank
    composited a band."""
    tr = port_trainer(job["root"], job["out"], mesh, STEPS,
                      job["tile_shard"])
    rows = []
    calls = []
    bands = prast.composite_bands
    prast.composite_bands = lambda *a: calls.append(1) or bands(*a)
    try:
        tr.train(iterations=STEPS, test_iterations=(), save_iterations=(),
                 on_iteration=lambda t, it, m: rows.append(
                     t._metrics_vector(m).tolist()))
    finally:
        prast.composite_bands = bands
    state, _ = tr.gathered()
    return dict(rows=rows, xyz=state.params.xyz.numpy(),
                shard_rows=tr.state.capacity, band_calls=len(calls),
                n_active=tr.num_active(), skips=tr.total_skips,
                pair_capacity=tr.pair_capacity)


# --- the tests ---------------------------------------------------------------

GRIDS = {"1x2": (1, 2, False), "2x1": (2, 1, False), "2x2": (2, 2, False),
         "1x2_bands": (1, 2, True)}


def jax_reference(root, out, n_data, n_gauss, tile):
    """Per-iteration losses and xyz after STEPS of JAX's mesh trainer."""
    jt = jax_trainer(root, out, jmesh.make_mesh(n_data, n_gauss), STEPS,
                     tile)
    losses = []
    jt.train(iterations=STEPS, test_iterations=(), save_iterations=(),
             on_iteration=lambda t, it, m: losses.append(float(m["loss"])))
    return (losses, np.asarray(jax.device_get(jt.state.params.xyz)),
            int(jt.state.num_active))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_mesh_trainer_matches_jax(grid, scene_root, tmp_path, monkeypatch):
    n_data, n_gauss, tile = GRIDS[grid]
    if tile:
        monkeypatch.setattr(jbin, "bin_sorted_pairs", functools.partial(
            jbin.bin_sorted_pairs, exact_grads=True))
    # JAX compiles in a thread while the ranks run.
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(jax_reference, scene_root, str(tmp_path / "jax"),
                          n_data, n_gauss, tile)
        results = run(n_data * n_gauss, dict(
            fn="_job_train", n_data=n_data, n_gauss=n_gauss,
            root=scene_root, out=str(tmp_path / "port"), tile_shard=tile),
            tmp_path)
        losses, want_xyz, want_active = ref.result()
    for got in results:
        rows = np.array(got["rows"])
        assert rows.shape == (STEPS, len(ptrainer.METRICS))
        np.testing.assert_allclose(rows[:, 0], losses, rtol=1e-5)
        np.testing.assert_allclose(got["xyz"], want_xyz, atol=1e-6)
        # what _drain acts on is the same on every rank, bit for bit
        assert got["rows"] == results[0]["rows"]
        assert not rows[:, ptrainer.METRICS.index("skipped")].any()
        assert not rows[:, ptrainer.METRICS.index("overflow")].any()
        assert got["n_active"] == want_active == 128
        assert got["shard_rows"] == STORE // n_gauss
        assert got["band_calls"] == (STEPS if tile else 0)
        assert got["skips"] == 0 and got["pair_capacity"] is None
    assert losses[-1] < losses[0]
