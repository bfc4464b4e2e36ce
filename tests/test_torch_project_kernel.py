"""K8 (``csrc/project_fwd.cu``), the projection of a store that autograd
does not record, and its place in ``ops/render.py``.

On the CPU: the render's projection counts its rows, none through K8, and
``records_grad`` follows autograd (the plain version is held against the
JAX package in ``test_torch_projection.py``). On the card (marker
``cuda``; each test skips without one): K8 against its plain version, a
frame through K8 against one through the plain version, one launch a
frame in ``eval_image``, none in the dense oracle's frame and none in a
training step. The file imports neither jax
nor the JAX package, so it also runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_project_kernel.py
"""

import dataclasses
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from priordepth_gaussiansplatting_torch import kernels
from priordepth_gaussiansplatting_torch.models import gaussians as gm
from priordepth_gaussiansplatting_torch.ops import projection, render
from priordepth_gaussiansplatting_torch.train import optim, step
from priordepth_gaussiansplatting_torch.utils import config, tracing
from priordepth_gaussiansplatting_torch.utils import testing as PT

torch.set_num_threads(2)
FIELDS = ("mean2d", "conic", "opacity", "rgb", "depth", "invdepth", "radius")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def override_colour(st):
    g = torch.Generator().manual_seed(3)
    return torch.rand(st.capacity, 3, generator=g).to(st.params.xyz.device)


# --- the CPU: the render's choice --------------------------------------------

def test_render_counts_the_projected_rows_and_none_through_k8_on_the_cpu():
    st = PT.edge_store(1, 3, device="cpu")
    cam = PT.axis_camera(device="cpu")
    with tracing.span("off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        render.render(cam, st, torch.zeros(3), backend="kernels")
    spans = [r for r in tracing.records() if r.name == "render.project"]
    assert len(spans) == 1
    assert spans[0].counts == {"project.rows": st.capacity,
                               "project.kernel_rows": 0}


def test_records_grad_follows_autograd():
    st = PT.edge_store(2, 3, device="cpu")
    cam = PT.axis_camera(device="cpu")
    assert not projection.records_grad(st, cam)
    leaf = st.replace(params=st.params.replace(
        xyz=st.params.xyz.clone().requires_grad_(True)))
    assert projection.records_grad(leaf, cam)
    with torch.no_grad():
        assert not projection.records_grad(leaf, cam)
    colour = override_colour(st).requires_grad_(True)
    assert projection.records_grad(st, cam, colour)


# --- the card ----------------------------------------------------------------

def card_cases(device):
    """(store, camera) of the card's checks: the render cells' frame sizes
    at 200,000 rows of a captured scene, and the edge rows."""
    m360 = PT.captured_store(11, 200_000, device=device)
    truck = PT.captured_store(12, 200_000, device=device)
    return {
        "m360_1297x840": (m360, PT.ring_camera(0.7, 1297, 840, 1160.0,
                                               device=device)),
        "truck_979x546": (truck, PT.ring_camera(2.1, 979, 546, 580.0, 2.5,
                                                0.3, device=device)),
        "edges": (PT.edge_store(7, 3, n=4096, device=device),
                  PT.axis_camera(device=device)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("aa", [False, True])
@pytest.mark.parametrize("case", ["m360_1297x840", "truck_979x546", "edges"])
def test_k8_against_its_plain_version_on_the_card(card, case, aa, override):
    """K8 against its plain version within the tolerances of
    ``utils/testing.py::projection_gaps``, the depth bit for bit. The radius,
    ceil(3 sqrt(lambda)), may move by one where lambda's last bits cross a
    whole number, and the cull where z lies within ulps of 0.2: each on a
    counted few rows. The edge rows, before a camera whose products are
    exact, match bit for bit."""
    st, cam = card_cases(card)[case]
    colour = override_colour(st) if override else None
    before = kernels.launch_counts()["project_fwd"]
    got = projection.project_state(st, cam, antialiasing=aa,
                                   override_color=colour)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["project_fwd"] == before + 1
    want = projection.project_state_plain(st, cam, antialiasing=aa,
                                          override_color=colour)
    if case == "edges":
        for name in FIELDS:
            assert torch.equal(bits(getattr(got, name)),
                               bits(getattr(want, name))), name
        return
    res = PT.projection_gaps(got, want, st, cam)
    few = 2 + st.capacity // 100_000
    assert res.pop("cull_moved") <= few and res.pop("radius_moved") <= few
    assert res.pop("radius_gap") <= 1 and res.pop("max_abs") < 0.1
    assert res.pop("depth_moved") == 0
    assert all(v <= 1 for v in res.values()), res
    culled = (got.radius == 0) & (want.radius == 0)
    for name, v in (("opacity", 0.0), ("depth", math.inf), ("invdepth", 0.0)):
        assert bool((getattr(got, name)[culled] == v).all()), name


def frame(st, cam, device):
    out = step.eval_image(cam, st, torch.zeros(3, device=device),
                          backend="kernels")
    return out["render"]


@pytest.mark.cuda
def test_a_frame_through_k8_matches_the_plain_frame(card, monkeypatch):
    """The same view through K8 and through its plain version: the depth
    order is the same, and where the two projections differ in a last bit
    (a conic or a colour one bf16 step apart, a radius one pixel apart)
    alpha and colour move by a bf16 step at most, a pixel by under two
    1/255 levels."""
    st, cam = card_cases(card)["truck_979x546"]
    got = frame(st, cam, card)
    monkeypatch.setattr(projection, "project_state",
                        projection.project_state_plain)
    want = frame(st, cam, card)
    gap = (got - want).abs() * 255
    assert float(gap.max()) <= 2, float(gap.max())
    assert float((gap > 1).float().mean()) <= 1e-3


@pytest.mark.cuda
def test_eval_image_launches_k8_once_a_frame(card):
    st, cam = card_cases(card)["m360_1297x840"]
    before = kernels.launch_counts()
    frame(st, cam, card)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    launched = {k: v - before[k] for k, v in after.items() if v != before[k]}
    assert launched == {"project_fwd": 1, "expand_pairs": 1,
                        "gather_rows": 1, "composite_fwd": 1}, launched


@pytest.mark.cuda
def test_the_dense_oracle_on_the_card_launches_no_kernel(card):
    """``backend="oracle"`` stays all PyTorch on the card: K8 follows the
    backend's choice of kernels."""
    st, cam = card_cases(card)["edges"]
    before = kernels.launch_counts()
    with torch.no_grad():
        render.render(cam, st, torch.zeros(3, device=card), backend="oracle")
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before


@pytest.mark.cuda
def test_a_training_step_launches_no_k8_and_keeps_its_gradients(
        card, monkeypatch):
    """A train step renders with gradients: the PyTorch projection, never
    K8, and the same update bit for bit with K8 out of reach."""
    st, _ = card_cases(card)["m360_1297x840"]
    cam = dataclasses.replace(
        PT.ring_camera(0.7, 648, 420, 580.0, device=card),
        image=torch.rand(3, 420, 648, device=card,
                         generator=torch.Generator(card).manual_seed(0)))
    fns = step.make_train_step(config.OptimizationConfig(),
                               config.PipelineConfig(backend="kernels"),
                               pair_capacity=1 << 22)
    bg = torch.zeros(3, device=card)

    def one_step():
        before = kernels.launch_counts()
        new, _, metrics = fns.step(st, optim.init_adam(st.params), cam, 1,
                                   None, bg)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert after["project_fwd"] == before["project_fwd"]
        assert after["composite_bwd"] == before["composite_bwd"] + 1
        assert int(metrics["skipped"]) == 0
        return new.params

    got = one_step()

    def refuse(*args, **kw):
        raise AssertionError("the training step reached K8")

    monkeypatch.setattr(projection, "project_state", refuse)
    want = one_step()
    for name in gm.PARAM_NAMES:
        assert torch.equal(bits(getattr(got, name)),
                           bits(getattr(want, name))), name
