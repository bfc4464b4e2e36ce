"""The sharded step's rasterizer backend: ``parallel/step.py::
_render_gathered`` accepts exactly the single-rank set (``auto``,
``kernels``, ``oracle``) and raises on anything else, so the JAX package's
``"pallas"`` fails loudly instead of running the dense oracle. Run in a
one-rank gloo group in this process; the rendered frames equal the
single-rank ``ops/render.py::render`` with the same backend exactly."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.ops import render as prender
from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
from priordepth_gaussiansplatting_torch.parallel import step as ppar
from priordepth_gaussiansplatting_torch.utils import config as pcfg
from priordepth_gaussiansplatting_torch.utils import testing as PT

torch.set_num_threads(2)
WH = 32


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "store"
    assert pmesh.initialize_multihost(f"file://{store}", 1, 0, device="cpu")
    try:
        yield pmesh.Mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def inputs():
    g = PT.random_gaussians(3, 48, scale_range=(0.05, 0.15))
    params = {
        "xyz": g["means"], "features_dc": g["sh"][:, :3],
        "features_rest": g["sh"][:, 3:], "scaling": np.log(g["scales"]),
        "rotation": g["quats"],
        "opacity": np.log(g["opacities"] / (1 - g["opacities"]))[:, None],
        "exposure": np.eye(3, 4, dtype=np.float32)[None]}
    state = interop.gaussian_state_from_numpy(params, np.ones(48, bool), 3, 3,
                                              device="cpu")
    cam = PT.look_at_camera((0, 0, -2.5), width=WH, height=WH, device="cpu")
    return state, cam


def render_gathered(backend, mesh):
    state, cam = inputs()
    return ppar._render_gathered(
        cam, state, torch.zeros(3), torch.zeros(state.capacity, 2),
        pcfg.PipelineConfig(backend=backend), mesh)


@pytest.mark.parametrize("backend", ["pallas", "Kernels", ""])
def test_unknown_backend_raises(backend, mesh):
    with pytest.raises(ValueError, match="unknown backend"):
        render_gathered(backend, mesh)


@pytest.mark.parametrize("backend", ["oracle", "kernels", "auto"])
def test_known_backends_run(backend, mesh):
    out, radii = render_gathered(backend, mesh)
    state, cam = inputs()
    want = prender.render(cam, state, torch.zeros(3), backend=backend,
                          clamp=False)
    assert torch.equal(out["render"], want["render"])
    assert torch.equal(radii, want["radii"])
    # the tile pipeline reports its pair counts, the dense oracle does not
    assert ("num_pairs" in out) == (backend == "kernels")
