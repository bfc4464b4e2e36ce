"""The port's spans and counts (``utils/tracing.py``) on the CPU: nothing
recorded without a profiler, the render's stages in ``eval_image`` on the
profiler's clock, the pair counts, a session's start, the train step's and
the trainer's spans, the train CLI's ``--profile`` trace, the repaired
``iter_time``, and the benchmark's readers of the spans on handmade
records. The scenes are tiny (300 Gaussians at 64x48; a 32x32, 4-view
raycast scene of 200 points) and run the tile pipeline's plain versions."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from priordepth_gaussiansplatting_torch import make_synthetic_scene
from priordepth_gaussiansplatting_torch.data import dataset
from priordepth_gaussiansplatting_torch.models import gaussians as gm
from priordepth_gaussiansplatting_torch.ops import projection, rasterize
from priordepth_gaussiansplatting_torch.train import __main__ as train_cli
from priordepth_gaussiansplatting_torch.train import step, trainer
from priordepth_gaussiansplatting_torch.utils import config, tracing
from priordepth_gaussiansplatting_torch.utils import testing as PT

torch.set_num_threads(2)
W, H = 64, 48
STAGES = ["render.project", "render.bin", "render.composite",
          "render.assemble"]
STEP_CHILDREN = ["render", "step.loss", "step.backward", "step.adam",
                 "step.stats"]
# The profiler's clock and time.time_ns() agree to well under this (ns).
SLACK_NS = 1_000_000


def small_state(n: int = 300):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    cols = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return gm.create_from_points(pts, cols, num_images=1, device="cpu")


def small_camera():
    cam = PT.look_at_camera((0.0, 0.0, -4.0), width=W, height=H,
                            device="cpu")
    img = torch.rand(3, H, W, generator=torch.Generator().manual_seed(1))
    return dataclasses.replace(cam, image=img)


def eval_frame(state, cam):
    return step.eval_image(cam, state, torch.zeros(3), backend="kernels")


def profiled(fn, *args):
    """fn(*args) under a CPU profiler session that follows a span made
    with the profiler off: (result, profiler, records)."""
    with tracing.span("off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof, tracing.records()


@pytest.fixture(scope="module")
def frame():
    state, cam = small_state(), small_camera()
    res, prof, recs = profiled(eval_frame, state, cam)
    return state, cam, res, prof, recs


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_without_a_profiler_span_is_the_shared_no_op_and_nothing_records():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("probe"):
            tracing.count("n", 1)
    before = tracing.records()
    assert [r.name for r in before] == ["probe"]
    assert tracing.span("render") is tracing.OFF
    with tracing.span("x") as s:
        assert s is tracing.OFF
        tracing.count("n", 1)
    eval_frame(small_state(), small_camera())
    assert tracing.records() == before


def test_eval_image_records_the_render_stages_nested(frame):
    recs = frame[4]
    names = by_name(recs)
    assert [r.name for r in recs] == ["eval", "render"] + STAGES + [
        "eval.score"]
    ev, rd = names["eval"][0], names["render"][0]
    assert ev.parent is None and rd.parent == ev.id
    assert names["eval.score"][0].parent == ev.id
    for name in STAGES:
        assert names[name][0].parent == rd.id, name
    ids = {r.id: r for r in recs}
    for r in recs:
        assert r.host_start <= r.host_end
        assert r.device_start is None and r.device_ms is None
        if r.parent is not None:
            p = ids[r.parent]
            assert p.host_start <= r.host_start <= r.host_end <= p.host_end
    # The stages follow one another inside the render.
    ends = [names[n][0] for n in STAGES]
    assert all(a.host_end <= b.host_start for a, b in zip(ends, ends[1:]))


@pytest.mark.parametrize("name, op", [
    ("render.project", "aten::sigmoid"),
    ("render.bin", "aten::sort"),
    ("render.composite", "aten::cumprod"),
    ("eval.score", "aten::log10"),
])
def test_a_span_holds_the_profiler_events_of_its_ops(frame, name, op):
    prof, recs = frame[3], frame[4]
    span = by_name(recs)[name][0]
    base = prof.profiler.kineto_results.trace_start_ns()
    hits = [(base + 1000 * e.time_range.start, base + 1000 * e.time_range.end)
            for e in prof.events() if e.name == op]
    assert hits, op
    for start, end in hits:
        assert span.host_start - SLACK_NS <= start, (name, op)
        assert end <= span.host_end + SLACK_NS, (name, op)
    # The op belongs to this span alone among the stages.
    for other in STAGES:
        if other != name:
            o = by_name(recs)[other][0]
            assert not any(o.host_start <= s and e <= o.host_end
                           for s, e in hits), (other, op)


def test_the_pair_counts_are_rasterizes(frame):
    state, cam, res, _, recs = frame
    proj = projection.project_gaussians(
        state.params.xyz, state.get_covariance(1.0), state.get_opacity(),
        state.get_features(), state.max_sh_degree, cam.world_view,
        cam.full_proj, cam.cam_center, W, H, cam.tan_fovx, cam.tan_fovy,
        valid_mask=state.active)
    out = rasterize.rasterize(proj, torch.zeros(3), W, H)
    counts = by_name(recs)["render.bin"][0].counts
    assert counts["pairs.rect"] == int(out["num_rect_pairs"]) > 0
    assert counts["pairs.valid"] == int(out["num_pairs"]) > 0
    assert counts["pairs.capacity"] == rasterize.default_pair_capacity(
        state.capacity)
    assert counts["pairs.overflow"] == int(out["overflow"]) == int(
        res["overflow"])
    assert all(isinstance(v, int) for v in counts.values())


def test_a_new_session_clears_the_last_sessions_records():
    _, _, recs = profiled(eval_frame, small_state(64), small_camera())
    assert sum(r.name == "eval" for r in recs) == 1
    first_ids = {r.id for r in recs}

    def one_span():
        with tracing.span("second"):
            tracing.count("k", torch.tensor(3))
            tracing.count("k", 4)

    _, _, recs2 = profiled(one_span)
    assert [r.name for r in recs2] == ["second"]
    assert recs2[0].counts == {"k": 7}
    assert not first_ids & {r.id for r in recs2}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("scene"))
    make_synthetic_scene.main(out, 32, 4, n_points=200)
    return out


def small_trainer(scene_dir, model_path="", iterations=3):
    return trainer.Trainer(
        config.ModelConfig(source_path=scene_dir, model_path=model_path,
                           eval=True),
        config.OptimizationConfig(iterations=iterations,
                                  noise_injection_iter=0,
                                  floating_prune_iter=0),
        config.PipelineConfig(backend="kernels"),
        dataset.Scene(scene_dir, eval_split=True, seed=0, device="cpu"),
        seed=0, quiet=True, device="cpu")


def test_three_trainer_iterations_give_three_steps_and_a_drain(scene_dir):
    tr = small_trainer(scene_dir)
    result, _, recs = profiled(lambda: tr.train(
        iterations=3, test_iterations=(), save_iterations=()))
    assert result["iterations_run"] == 3
    names = by_name(recs)
    steps = names["step"]
    assert len(steps) == 3
    for s in steps:
        kids = [r.name for r in recs if r.parent == s.id]
        assert kids == STEP_CHILDREN, kids
        render = next(r for r in recs if r.parent == s.id
                      and r.name == "render")
        assert [r.name for r in recs if r.parent == render.id] == STAGES
    drain = names["train.drain"]
    assert len(drain) == 1 and drain[0].parent is None
    assert drain[0].host_start >= steps[-1].host_end
    assert drain[0].counts == {"skipped": result["skipped"]}


def test_the_profile_trace_holds_the_step_spans(scene_dir, tmp_path):
    model = str(tmp_path / "model")
    with tracing.span("off"):
        pass
    train_cli.main(["-s", scene_dir, "-m", model, "--data_device", "cpu",
                    "--eval", "--backend", "kernels", "--disable_viewer",
                    "--quiet", "--iterations", "3", "--test_iterations",
                    "3", "--save_iterations", "3", "--noise_injection_iter",
                    "0", "--floating_prune_iter", "0", "--profile"])
    with open(os.path.join(model, "trace", "trace.json")) as f:
        trace = json.load(f)
    ev = trace["traceEvents"]
    mine = [e for e in ev if e.get("pid") == tracing.HOST_PID
            and e.get("ph") == "X"]
    steps = [e for e in mine if e["name"] == "step"]
    assert len(steps) == 3
    assert {e["name"] for e in mine} >= {"step", "render", "step.backward",
                                         "train.drain", "train.report",
                                         "train.save", "eval"}
    # On the trace's own time base: the profiler's sort events of a step's
    # binning lie inside that step's span.
    sorts = [e for e in ev if e.get("name") == "aten::sort"
             and e.get("ph") == "X"]
    slack = SLACK_NS / 1e3
    inside = [s for s in sorts if any(
        st["ts"] - slack <= s["ts"] and s["ts"] + s["dur"]
        <= st["ts"] + st["dur"] + slack for st in steps)]
    assert len(inside) >= 2 * len(steps)
    assert not [e for e in ev if e.get("pid") == tracing.DEVICE_PID
                and e.get("ph") == "X"]


def test_iter_time_is_ms_per_iteration_of_the_block(scene_dir, tmp_path):
    model = str(tmp_path / "model")
    tr = small_trainer(scene_dir, model, iterations=10)
    result = tr.train(iterations=10, test_iterations=(), save_iterations=())
    tr.logger.close()
    with open(os.path.join(model, "events.jsonl")) as f:
        got = [json.loads(line) for line in f]
    logged = [e for e in got if e.get("tag") == "iter_time"]
    assert [e["step"] for e in logged] == [10]
    ms = [e["value"] for e in logged]
    # One block of 10 iterations: its mean is positive and its total within
    # the run's wall time.
    assert 0 < ms[0] and 10 * ms[0] <= 1e3 * result["wall_s"]


class Reading:
    """What a reader is given, as far as the span readers look."""

    def __init__(self, units):
        self.units, self.span = units, object()


def handmade(frames: int):
    """Records of `frames` frames: device ms 1, 2, 3, 4 for the stages
    (+0.5 on odd frames), 10 host ms an eval, 100 rect and 40 + frame
    valid pairs a bin."""
    recs, i = [], 0
    for f in range(frames):
        t = f * 100_000_000
        extra = 0.5e6 * (f % 2)
        ev = tracing.Record("eval", i, None, 1, t, t + 10_000_000, 0.0, 1.0,
                            {}, {})
        recs.append(ev)
        d = float(t)
        for k, name in enumerate(STAGES):
            dur = (k + 1) * 1e6 + extra
            counts = ({"pairs.rect": 100, "pairs.valid": 40 + f,
                       "pairs.capacity": 4096, "pairs.overflow": 0}
                      if name == "render.bin" else {})
            recs.append(tracing.Record(name, i + k + 1, i, 1, t, t, d,
                                       d + dur, {}, counts))
            d += dur
        i += len(STAGES) + 1
    return recs


@pytest.mark.parametrize("metric, want", [
    ("project_ms.render", 1.25), ("bin_ms.render", 2.25),
    ("composite_ms.render", 3.25), ("assemble_ms.render", 4.25),
    ("dispatch_ms.render", 10.0),
    ("pairs_kept.render", 100.0 * (40 + 41 + 42 + 43) / 400),
])
def test_the_span_readers_on_handmade_records(metric, want, monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: handmade(4))
    read = harness.reader("layer_metrics", metric)
    assert read(Reading(4)) == pytest.approx(want, rel=1e-12)
    # A session that does not hold one eval span a frame reads nothing.
    assert read(Reading(5)) is None
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert read(Reading(4)) is None


def test_chrome_events_put_each_span_on_the_host_track():
    def nested():
        with tracing.span("outer"):
            with tracing.span("inner"):
                tracing.count("c", torch.tensor([5]))

    _, _, recs = profiled(nested)
    base = recs[0].host_start - 1000
    ev = tracing.chrome_events(base)
    meta = [e for e in ev if e["ph"] == "M"]
    assert {e["pid"] for e in meta} == {tracing.HOST_PID, tracing.DEVICE_PID}
    xs = [e for e in ev if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["outer", "inner"]
    outer, inner = xs
    assert outer["ts"] == pytest.approx(1.0)
    assert outer["ts"] <= inner["ts"] and (inner["ts"] + inner["dur"]
                                           <= outer["ts"] + outer["dur"])
    assert inner["args"]["parent"] == outer["args"]["id"]
    assert inner["args"]["c"] == 5
    json.dumps(ev)
