"""The readers of the program's own spans (``benchmark/spans.py``): on
handmade records and device operations, and in a tiny traced training run
on the CPU, where the spans have host intervals and no device ones; and
the traced span's matching of device operations to their launches
(``benchmark/trace.py``)."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness, spans, trace
from benchmark.tests.conftest import SEED, TRAIN_CELLS, tiny_config, tiny_mix

from priordepth_gaussiansplatting_torch.utils import tracing

STAGES = ("render", "step.loss", "step.backward", "step.adam", "step.stats")
READERS = {"fwd_ms.train": "render", "loss_ms.train": "step.loss",
           "backward_ms.train": "step.backward", "adam_ms.train": "step.adam"}
MS = 1_000_000
STEP = 100 * MS


class Reading:
    """What a reader is given, as far as the span readers look."""

    def __init__(self, units, launched=(), unlinked=0):
        self.units = units
        self.span = SimpleNamespace(launched=list(launched),
                                    unlinked=unlinked)


def rec(name, i, parent, h0, h1, d0=0.0, d1=1.0):
    return tracing.Record(name, i, parent, 1, h0, h1, d0, d1, {}, {})


def handmade(steps: int):
    """Records and device operations of `steps` steps. Step s opens at
    s x 100 ms and is open 40 ms on the host; its stage k is open on the
    host over [t + 5k ms, t + 5k + 4 ms] and launches two operations there,
    each (k + 1) / 2 ms long (+0.25 ms on odd steps), run 30 ms later with
    a gap between them (the device's idle time, which no busy reading
    counts). Before each step a drain span holds a `render` of its own that
    launches 7 ms of work: outside any step, so no reader counts it."""
    recs, ops, i = [], [], 0
    for s in range(steps):
        t = s * STEP
        recs += [rec("train.drain", i, None, t - 9 * MS, t - MS),
                 rec("render", i + 1, i, t - 8 * MS, t - 2 * MS)]
        ops.append((t - 5 * MS, t - 5 * MS, t + 2 * MS))
        step = i + 2
        recs.append(rec("step", step, None, t, t + 40 * MS, 0.0, 15e6))
        for k, name in enumerate(STAGES):
            h0 = t + 5 * k * MS
            recs.append(rec(name, step + k + 1, step, h0, h0 + 4 * MS,
                            0.0, 9e9))
            dur = (k + 1) * MS // 2 + (s % 2) * MS // 4
            for j in range(2):
                d0 = h0 + 30 * MS + j * 3 * dur
                ops.append((h0 + j * MS, d0, d0 + dur))
        i = step + len(STAGES) + 1
    return recs, sorted(ops)


@pytest.mark.parametrize("metric, stage", sorted(READERS.items()))
def test_the_stage_readers_read_busy_device_ms(metric, stage, monkeypatch):
    k = STAGES.index(stage)
    recs, ops = handmade(4)
    monkeypatch.setattr(tracing, "records", lambda: recs)
    read = harness.reader("layer_metrics", metric)
    # Two operations a step of (k + 1) / 2 ms, a quarter more on odd steps.
    assert read(Reading(4, launched=ops)) == pytest.approx(k + 1.25,
                                                           rel=1e-12)
    # A session that does not hold one step span a traced iteration reads
    # nothing, nor one without device operations or with one whose launch
    # went unmatched.
    assert read(Reading(5, launched=ops)) is None
    assert read(Reading(4, launched=ops, unlinked=1)) is None
    assert read(Reading(4)) is None
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert read(Reading(4, launched=ops)) is None


def test_busy_time_counts_overlapping_operations_once(monkeypatch):
    recs = [rec("step", 0, None, 0, 10 * MS),
            rec("step.adam", 1, 0, MS, 5 * MS)]
    ops = [(2 * MS, 20 * MS, 24 * MS), (3 * MS, 22 * MS, 23 * MS),
           (4 * MS, 23 * MS, 26 * MS), (6 * MS, 30 * MS, 31 * MS)]
    monkeypatch.setattr(tracing, "records", lambda: recs)
    r = Reading(1, launched=ops)
    assert spans.busy_ms_per_unit(r, "step", "step.adam") == (
        pytest.approx(6.0))
    # The step holds the fourth operation too.
    assert spans.busy_ms_per_unit(r, "step", "step") == pytest.approx(7.0)


def test_dispatch_reads_the_step_spans_host_time(monkeypatch):
    recs, _ = handmade(4)
    monkeypatch.setattr(tracing, "records", lambda: recs)
    read = harness.reader("layer_metrics", "dispatch_ms.train")
    assert read(Reading(4)) == pytest.approx(40.0, rel=1e-12)
    assert read(Reading(3)) is None


def test_a_render_session_reads_no_step(monkeypatch):
    recs = [rec("eval", 2 * f, None, 0, 10) for f in range(3)]
    recs += [rec("render", 2 * f + 1, 2 * f, 0, 10) for f in range(3)]
    ops = [(5, 5, 6)]
    monkeypatch.setattr(tracing, "records", lambda: recs)
    for metric in list(READERS) + ["dispatch_ms.train"]:
        read = harness.reader("layer_metrics", metric)
        assert read(Reading(3, launched=ops)) is None


def render_frames(frames: int):
    """Records of `frames` frames: eval > render > the four stages, stage k
    of frame f (k + 1 + f / 10) device ms long, with counts on
    render.bin."""
    recs, i = [], 0
    for f in range(frames):
        t = f * STEP
        recs += [rec("eval", i, None, t, t + 30 * MS),
                 rec("render", i + 1, i, t, t + 20 * MS)]
        for k, name in enumerate(("render.project", "render.bin",
                                  "render.composite", "render.assemble")):
            d0 = float(t + 10 * k * MS)
            r = rec(name, i + 2 + k, i + 1, t, t, d0,
                    d0 + (k + 1 + f / 10) * MS)
            if name == "render.bin":
                r.counts.update({"pairs.valid": 80 + f, "pairs.rect": 100})
            recs.append(r)
        i += 6
    return recs


@pytest.mark.parametrize("metric, stage", [
    ("project_ms.render", 0), ("bin_ms.render", 1),
    ("composite_ms.render", 2), ("assemble_ms.render", 3)])
def test_the_render_stage_readers_read_the_stage_intervals(metric, stage,
                                                           monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: render_frames(4))
    read = harness.reader("layer_metrics", metric)
    # Stage k reads (k + 1 + f / 10) ms in frame f: the mean is k + 1.15.
    assert read(Reading(4)) == pytest.approx(stage + 1.15, rel=1e-12)
    assert read(Reading(5)) is None
    # A session of training steps holds no eval span.
    monkeypatch.setattr(tracing, "records", lambda: handmade(4)[0])
    assert read(Reading(4)) is None


def test_the_render_span_readers_dispatch_and_pairs(monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: render_frames(4))
    r = Reading(4)
    assert harness.reader("layer_metrics", "dispatch_ms.render")(r) == (
        pytest.approx(30.0, rel=1e-12))
    assert harness.reader("layer_metrics", "pairs_kept.render")(r) == (
        pytest.approx(100.0 * (80 + 81 + 82 + 83) / 400, rel=1e-12))


def event(name, i, start, end, device=False):
    return SimpleNamespace(
        name=name, id=i, thread=1, self_cpu_time_total=end - start,
        time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_the_traced_span_matches_device_work_to_its_launch():
    events = [event("aten::add", 7, 0.0, 5.0),
              event("cudaLaunchKernel", 7, 1.0, 2.0),
              event("cuLaunchKernel", 8, 3.0, 4.0),
              event("add_kernel", 7, 10.0, 12.0, device=True),
              event("composite_fwd_kernel", 8, 12.5, 20.0, device=True),
              event("Memcpy DtoH", 9, 21.0, 22.0, device=True)]
    prof = SimpleNamespace(
        events=lambda: events,
        profiler=SimpleNamespace(kineto_results=SimpleNamespace(
            trace_start_ns=lambda: 1_000_000)))
    span = trace.Span(prof, 1.0)
    # Times in ns on the profiler's clock; the copy had no launch recorded.
    assert span.launched == [(1_001_000, 1_010_000, 1_012_000),
                             (1_003_000, 1_012_500, 1_020_000)]
    assert span.unlinked == 1
    assert span.launches == 2


@pytest.mark.parametrize("wl", TRAIN_CELLS, ids=lambda w: w["name"])
def test_a_tiny_traced_training_run_reads_the_step_spans(wl):
    spec = harness.load_spec()
    names = list(READERS) + ["dispatch_ms.train"]
    spec = dict(spec, workloads=spec["workloads"] + [wl], per_layer=[
        {"name": n, "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "train step", "moves": "setup_s",
         "workloads": [wl["name"]]} for n in names])
    out = harness.run_cell(spec, wl, SEED, 0.5, True, 0.0, device="cpu",
                           cfg=tiny_config(wl["config"]),
                           mix=tiny_mix(wl["traffic"]))
    assert out["correct"] and out["attempted"] > 0
    # The CPU has host intervals and no device operations.
    assert set(out["metrics"]) == {"dispatch_ms.train"}
    assert out["metrics"]["dispatch_ms.train"]["value"] > 0
