"""Check the program's own spans (``priordepth_gaussiansplatting_torch/
utils/tracing.py``) against the profiler's events in one traced span of a
render cell, and measure what the recorder costs:

    python3 -m benchmark.span_check --workload <cell> --seed <n> \
        [--frames <n>] [--out <file.json>]

On the card, as the harness runs the cell (set-up, then the mix's traced
frames under torch.profiler with CPU and CUDA activity), it prints one
JSON object: the cell's per-layer metrics, and

  k2            ``composite_ms.render`` against the profiler's K2
                (``composite_fwd_kernel``) device ms a frame
  containment   each K2 launch's interval against its frame's
                ``render.composite`` device interval (ns outside it)
  host_truth    the spans' device intervals against the host clock alone:
                each frame's done before the host began the next frame;
                and how many K2 launches the profiler places before their
                span began on the host
  stages        the four stages' device ms against the ``render`` span's,
                frame by frame
  pairs         ``pairs.valid`` of each frame against the reference's
                needed pairs of its view and against ``pairs.rect``
  host          the profiler's ``aten::sort`` events against the
                ``render.bin`` host intervals
  by_stage      the profiler's device operations put down to the stage
                whose device interval holds them
  anchor        the spread of 100 repeated anchors about the line the
                recorder places device times by (the error of a device
                time on the host clock), and the timer's drift
  cost          ns a span with the profiler off; µs the spans add to a
                frame of tiny kernels under the profiler (frames with and
                without them in turns), and a span's parts; the
                profiler's ``cudaEventRecord`` calls a frame, and its
                device events named as a span (none: no span reaches the
                profiler)

with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import time

import torch

from . import drivers, harness, trace

STAGES = ("render.project", "render.bin", "render.composite",
          "render.assemble")
K2 = "composite_fwd_kernel"


@contextlib.contextmanager
def _tracer(keep: dict):
    """The harness's traced span, keeping the profiler as well."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    keep["prof"] = prof
    keep["span"] = trace.Span(prof, wall)


def _quartiles(values):
    q = statistics.quantiles(values, n=4)
    return {"min": min(values), "q1": q[0], "median": q[1], "q3": q[2],
            "max": max(values)}


def off_cost_ns(tracing, n: int = 200_000) -> float:
    """ns a span costs with the profiler off, over an empty loop's."""
    with tracing.span("off"):
        pass
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tracing.span("render.project"):
            pass
    t1 = time.perf_counter_ns()
    for _ in range(n):
        pass
    t2 = time.perf_counter_ns()
    return ((t1 - t0) - (t2 - t1)) / n


def anchor_spread(tracing, repeats: int = 100) -> dict:
    """Repeat the anchor, 1 ms apart: each anchor's host stamp less the
    host time the recorder would give its event, placed by the line
    through the first and the last anchor (ns). Their spread is the error
    of a device time on the host clock; ``drift_ppm`` is how far the
    device's timer ran from the host clock."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(repeats)]
    stamps = []
    for ev in events:
        stamps.append(tracing.anchor(ev))
        time.sleep(0.001)
    dev = [1e6 * events[0].elapsed_time(ev) for ev in events]
    scale = (stamps[-1] - stamps[0]) / dev[-1]
    res = [s - (stamps[0] + scale * d) for s, d in zip(stamps, dev)]
    inner = res[1:-1]
    return dict(_quartiles(inner), spread=max(inner) - min(inner),
                drift_ppm=1e6 * (scale - 1.0), repeats=repeats)


def _frame(tracing, x, spans: bool) -> None:
    """A frame's span structure (eval, render and its four stages,
    eval.score), each stage launching one tiny kernel; without the spans
    when `spans` is false."""
    if not spans:
        for _ in range(len(STAGES) + 1):
            x.add_(1.0)
        return
    with tracing.span("eval"):
        with tracing.span("render"):
            for name in STAGES:
                with tracing.span(name):
                    x.add_(1.0)
        with tracing.span("eval.score"):
            x.add_(1.0)


def on_cost_us(tracing, frames: int = 2000) -> dict:
    """µs of host time the spans add to a frame under a profiler with CUDA
    activity: frames of five tiny kernels with and without the spans, in
    turns (without, with, with, without), each a profiler session of its
    own; and, per call under the same profiler, what a boundary event
    costs: making the current stream's object, and the record."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    per = {False: [], True: []}
    for spans in (False, True, True, False):
        with tracing.span("off"):
            pass
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            t0 = time.perf_counter_ns()
            for _ in range(frames):
                _frame(tracing, x, spans)
            torch.cuda.synchronize()
            per[spans].append((time.perf_counter_ns() - t0) / frames / 1e3)
    out = {"frame_without_spans_us": per[False],
           "frame_with_spans_us": per[True],
           "spans_us_per_frame": (sum(per[True]) - sum(per[False])) / 2}
    n = 5000
    stream = torch.cuda.current_stream()
    old = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for ev in old:
        ev.record(stream)
    parts = {
        "current_stream": lambda i: torch.cuda.current_stream(),
        "event_record_on_stream": lambda i: old[i].record(stream),
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for name, fn in parts.items():
            t0 = time.perf_counter_ns()
            for i in range(n):
                fn(i)
            out[f"{name}_us"] = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return out


def check(drv, keep: dict, recs, stats: dict, units: int,
          err_ns: float) -> dict:
    """The cross-checks of the spans against the profiler's events."""
    from torch.autograd import DeviceType
    prof, span = keep["prof"], keep["span"]
    base = prof.profiler.kineto_results.trace_start_ns()
    k2, sorts, dev_ops, named, records = [], [], [], 0, 0
    names = {r.name for r in recs}
    for e in prof.events():
        start = base + 1000 * e.time_range.start
        end = base + 1000 * e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev_ops.append((start, end, e.name))
            if K2 in e.name:
                k2.append((start, end))
            if e.name in names:
                named += 1
        elif e.name == "aten::sort":
            sorts.append((start, end))
        elif e.name.startswith("cudaEventRecord"):
            records += 1
    k2.sort()
    dev_ops.sort()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    comp = by["render.composite"]
    k2_s, k2_n = span.kernel_seconds(K2)
    k2_ms = 1e3 * k2_s / units
    comp_ms = sum(r.device_ms for r in comp) / units
    # Each frame launches K2 once, in its render.composite span.
    outside = [max(c.device_start - s, e - c.device_end, 0.0)
               for c, (s, e) in zip(comp, k2)]
    after_start = [s - c.device_start for c, (s, e) in zip(comp, k2)]
    before_end = [c.device_end - e for c, (s, e) in zip(comp, k2)]
    # A host truth, the profiler aside: a frame's device work ends before
    # the host starts the next frame (the frame ends by copying its image
    # to the host). Beside it, each frame's first event against the host
    # time stamped just after its record (negative by the record's own
    # time, more where the host thread lost the processor in between).
    evals = by["eval"]
    after_record = [r.device_start - r.host_start for r in evals]
    before_next = [n.host_start - r.device_end
                   for r, n in zip(evals, evals[1:])]
    k2_before_host = sum(s < c.host_start for c, (s, e) in zip(comp, k2))
    bins = by["render.bin"]
    kids = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    excess = [sum(k.device_ms for k in kids[r.id] if k.name in STAGES)
              - r.device_ms for r in by["render"]]
    needed = [stats[v][0]["needed_pairs"] for v in drv.span_views]
    valid = [b.counts["pairs.valid"] for b in bins]
    rect = [b.counts["pairs.rect"] for b in bins]
    bin_hosts = sorted((b.host_start, b.host_end) for b in bins)
    sorts_out = sum(not any(h0 <= s and e <= h1 for h0, h1 in bin_hosts)
                    for s, e in sorts)
    return {
        "k2": {"composite_ms": comp_ms, "profiler_k2_ms": k2_ms,
               "gap_ms": comp_ms - k2_ms,
               "limit_ms": max(0.05 * k2_ms, 0.05),
               "holds": abs(comp_ms - k2_ms) <= max(0.05 * k2_ms, 0.05),
               "launches": k2_n, "spans": len(comp)},
        "containment": {"launches": len(k2), "spans": len(comp),
                        "outside_ns": _quartiles(outside),
                        "k2_start_after_span_ns": _quartiles(after_start),
                        "k2_end_before_span_ns": _quartiles(before_end),
                        "error_ns": err_ns,
                        "holds": len(k2) == len(comp)
                        and max(outside) <= err_ns},
        "host_truth": {"done_before_next_frame_ns": _quartiles(before_next),
                       "holds": min(before_next) >= -err_ns,
                       "device_start_less_host_start_ns": _quartiles(
                           after_record),
                       "profiler_k2_before_its_span_on_host": k2_before_host},
        "by_stage": by_stage(recs, dev_ops, units),
        "stages": {"excess_ms": _quartiles(excess),
                   "holds": max(excess) <= 1e-3},
        "pairs": {"valid_over_needed": _quartiles(
                      [v / n for v, n in zip(valid, needed)]),
                  "valid_over_rect": _quartiles(
                      [v / r for v, r in zip(valid, rect)]),
                  "holds": all(n <= v <= r for v, n, r
                               in zip(valid, needed, rect))},
        "host": {"sorts": len(sorts), "outside_render_bin": sorts_out},
        "profiler": {"cudaEventRecord_per_frame": records / units,
                     "device_events_named_as_spans": named},
    }


def by_stage(recs, dev_ops, units: int) -> dict:
    """The profiler's device operations put down to the stage (or
    ``eval.score``) whose device interval holds their start: busy ms a
    frame and the top operations of each, ms a frame."""
    spans = sorted((r.device_start, r.device_end, r.name) for r in recs
                   if r.name in STAGES + ("eval.score",))
    starts = [s[0] for s in spans]
    busy, ops = {}, {}
    for s, e, name in dev_ops:
        i = bisect.bisect_right(starts, s) - 1
        stage = (spans[i][2] if i >= 0 and s < spans[i][1]
                 else "outside the stages")
        busy[stage] = busy.get(stage, 0.0) + (e - s) / 1e6 / units
        top = ops.setdefault(stage, {})
        top[name[:60]] = top.get(name[:60], 0.0) + (e - s) / 1e6 / units
    return {k: {"busy_ms": busy[k],
                "top_ms": sorted(ops[k].items(), key=lambda kv: -kv[1])[:6]}
            for k in busy}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=None,
                    help="traced frames (default: the mix's)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_check needs a CUDA card", file=sys.stderr)
        return 2
    from priordepth_gaussiansplatting_torch.utils import tracing
    t0 = time.perf_counter()
    spec = harness.load_spec()
    wl = next(w for w in spec["workloads"] if w["name"] == args.workload)
    cfg = harness.load_json("configs", wl["config"])
    mix = harness.load_json("traffic", wl["traffic"])
    if args.frames:
        mix["trace_frames"] = args.frames
    drv = drivers.load(mix["driver"])(cfg, mix, args.seed, "cuda")
    drv.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    off_ns = off_cost_ns(tracing)
    anchor = anchor_spread(tracing)
    keep = {}
    drv.span(_tracer(keep))
    recs = tracing.records()
    reading = harness.Reading(drv, setup_s, keep["span"])
    with torch.no_grad():
        stats = drv.span_stats()
    reading._stats = [tuple(v) for v in stats.values()]
    metrics = {}
    for m in harness.cell_metrics(spec, wl["name"], "per_layer"):
        metrics[m["name"]] = harness.reader("layer_metrics",
                                            m["name"])(reading)
    out = {"workload": wl["name"], "seed": args.seed, "frames": drv.units,
           "metrics": metrics, "anchor_ns": anchor}
    out.update(check(drv, keep, recs, stats, drv.units, anchor["spread"]))
    out["cost"] = {"off_ns_per_span": off_ns,
                   "on_us": on_cost_us(tracing),
                   "spans_per_frame": len(recs) / drv.units}
    out["device"] = harness.card()
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
