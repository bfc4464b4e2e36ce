"""The traced span: torch.profiler over CPU and CUDA activity, reduced to
what the per-layer metrics read.

Device time is the union of the device's activity intervals (kernels,
copies, sets), so that overlapping kernels count once. Host time is the
self time of the main thread's operations, less the calls that only wait
for the device. Idle gaps are the stretches between device intervals,
each named by the innermost host operation running at its start. Each
device operation is also kept with the host time of the runtime call that
launched it (matched by the profiler's correlation id), for the readers of
the work a program span launched.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

# Host calls that wait for the device rather than dispatch work.
WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync",
         "aten::_local_scalar_dense", "aten::item", "aten::copy_",
         "aten::to", "aten::_to_copy")


class Span:
    """What one traced span left behind, reduced."""

    def __init__(self, prof, wall_s: float):
        from torch.autograd import DeviceType
        dev, cpu, runtime, ids = [], {}, {}, []
        self.kernels = {}
        self.launches = 0
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                dev.append((start, end))
                ids.append(e.id)
                acc = self.kernels.setdefault(e.name, [0.0, 0])
                acc[0] += (end - start) / 1e6
                acc[1] += 1
                if not e.name.startswith(("Memcpy", "Memset")):
                    self.launches += 1
            else:
                cpu.setdefault(e.thread, []).append(e)
                if e.name.startswith("cu"):
                    runtime[e.id] = start
        # The main thread is the one that dispatched the most operations.
        host = max(cpu.values(), key=len) if cpu else []
        self.wall_s = wall_s
        merged = []
        for s, e in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        self.host_s = sum(e.self_cpu_time_total for e in host
                          if e.name not in WAITS) / 1e6
        self.gaps = self._gaps(merged, host)
        self.launched, self.unlinked = self._launched(prof, dev, ids,
                                                      runtime)

    @staticmethod
    def _launched(prof, dev, ids, runtime):
        """([(launch, start, end) ns on the profiler's clock, ordered by
        launch], how many device operations had no launch to match)."""
        if not dev:
            return [], 0
        base = prof.profiler.kineto_results.trace_start_ns()
        got = sorted((base + 1000 * runtime[i], base + 1000 * s,
                      base + 1000 * e)
                     for (s, e), i in zip(dev, ids) if i in runtime)
        return got, len(dev) - len(got)

    @staticmethod
    def _gaps(merged, host, keep: int = 10):
        """The `keep` longest idle stretches between device intervals, each
        named by the innermost host operation open at its start."""
        spans = sorted((merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)
                       if merged[i + 1][0] > merged[i][1])
        spans = sorted(spans, key=lambda g: g[0] - g[1])[:keep]
        ops = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in host)
        starts = [o[0] for o in ops]
        out = []
        for s, e in spans:
            name, width = "host idle", None
            i = bisect.bisect_right(starts, s)
            for j in range(i - 1, max(i - 4000, -1), -1):
                os_, oe, on = ops[j]
                if oe >= s and (width is None or oe - os_ < width):
                    name, width = on, oe - os_
            out.append([name, (e - s) / 1e6])
        return out

    def top_ops(self, keep: int = 10):
        return [[name[:120], v[0]] for name, v in
                sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:keep]]

    def kernel_seconds(self, marker: str):
        """(seconds, launches) of the device operations whose name holds
        `marker`, or None when none ran."""
        hits = [v for k, v in self.kernels.items() if marker in k]
        if not hits:
            return None
        return sum(h[0] for h in hits), sum(h[1] for h in hits)


@contextlib.contextmanager
def traced(out: dict):
    """Profile the block; on exit ``out["span"]`` holds its :class:`Span`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["span"] = Span(prof, wall)
