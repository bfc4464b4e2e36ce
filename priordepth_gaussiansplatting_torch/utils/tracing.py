"""Spans and counts inside the port, on the profiler's clock.

Off unless a torch profiler is recording. :func:`span` then reads one flag
of torch's (``torch.autograd.profiler._is_profiler_enabled``, kept for fast
checks) and returns a shared no-op; :func:`count` returns at once.

Under a profiler a span records its name, id, parent (the innermost open
span of its thread) and thread, its host start and end from
``time.time_ns()`` (the clock of the profiler's events), the kernel
launches it made (``kernels.launch_counts()``), and with CUDA initialised a
timing event on the current stream at each boundary. A span that begins
where its sibling ended (the next span its parent opens) shares that
sibling's end event, so work its parent dispatches between the two falls
to the later one. :func:`count` adds a value to the innermost open span:
an int, or a one-element tensor that is kept and read only by
:func:`records`, so that a count makes the path wait for nothing.

The records stay in memory: no ``record_function`` or NVTX range is made,
so the profiler's own events are the program's work alone.
:func:`records` reads them, with each span's device interval placed on the
host clock by anchors: events recorded on an idle stream, each with the
host time just before its record (one as the session starts, one at each
top-level span that opens on an idle stream, one as the records are
read). :func:`chrome_events` formats the records for a chrome trace. A
session begins at the first span that finds the profiler on after a span
that found it off, and its start clears the last session's records.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

from .. import kernels

# Anchors are taken in turn over windows of this many ns of device time.
WINDOW_NS = 250_000_000
# The chrome trace's process ids of the spans' host and device tracks.
HOST_PID = 1_000_000_001
DEVICE_PID = 1_000_000_002


@dataclasses.dataclass(frozen=True)
class Record:
    """One closed span. Times are ns on ``time.time_ns()``'s clock; the
    device interval is that between the span's boundary events on its
    stream, None without CUDA."""

    name: str
    id: int
    parent: Optional[int]
    thread: int
    host_start: int
    host_end: int
    device_start: Optional[float]
    device_end: Optional[float]
    launches: dict
    counts: dict

    @property
    def host_ms(self) -> float:
        return (self.host_end - self.host_start) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start is None:
            return None
        return (self.device_end - self.device_start) / 1e6


class _Off:
    """The span handed out while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "thread", "host_start", "host_end",
                 "start_event", "end_event", "launches", "counts")

    def __init__(self, name: str):
        self.name = name
        self.host_end = None
        self.start_event = self.end_event = None
        self.counts = {}

    def __enter__(self):
        _REC.open(self)
        return self

    def __exit__(self, *exc):
        _REC.close(self)
        return False


def anchor(event: torch.cuda.Event) -> int:
    """Record `event` on the idle device and return the host time just
    before the record: the device stamps the event no earlier, and most
    often a few µs later (at times tens or hundreds of µs, when it is slow
    to take the work up, or the host thread is preempted). A point that
    ties the device's event times to the host clock."""
    torch.cuda.synchronize()
    ns = time.time_ns()
    event.record()
    event.synchronize()
    return ns


class _Recorder:
    """The spans of the current session. One per process (``_REC``): the
    profiler that turns it on is process-wide too."""

    def __init__(self):
        # Whether the last span found the profiler on.
        self.live = False
        self.spans = []
        self.ids = itertools.count()
        self.local = threading.local()
        self.pool = []
        self.cuda = False
        # (event, host ns) pairs, and each event's last anchor before it.
        self.anchors = []
        self.segment = {}
        self.read = None
        self.device = self.raw = self.stream = None

    def _start(self) -> None:
        """A new session: the last one's events go back to the pool."""
        self.live = True
        used = {id(e): e for s in self.spans
                for e in (s.start_event, s.end_event) if e is not None}
        used.update((id(e), e) for e, _ in self.anchors)
        self.pool.extend(used.values())
        self.spans = []
        self.read = None
        self.local = threading.local()
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.anchors = []
        self.segment = {}
        if self.cuda:
            self.device = torch.cuda.current_device()
            self.raw = None
            ev = self._event_object()
            self.anchors.append((ev, anchor(ev)))

    def _event_object(self) -> torch.cuda.Event:
        return self.pool.pop() if self.pool else torch.cuda.Event(
            enable_timing=True)

    def _event(self, top: bool = False) -> torch.cuda.Event:
        """A timing event recorded on the current stream. The stream object
        is made again only when the current stream changes: making it
        costs more than the record. A `top` span's start event recorded
        on an idle stream is an anchor as well (see :func:`anchor`)."""
        raw = torch._C._cuda_getCurrentRawStream(self.device)
        if raw != self.raw:
            self.raw = raw
            self.stream = torch.cuda.current_stream(self.device)
        ev = self._event_object()
        if top and self.stream.query():
            self.anchors.append((ev, time.time_ns()))
        ev.record(self.stream)
        self.segment[id(ev)] = len(self.anchors) - 1
        return ev

    def _stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
            self.local.tail = None
        return stack

    def open(self, s: _Span) -> None:
        if not self.live:
            self._start()
        stack = self._stack()
        s.parent = stack[-1].id if stack else None
        s.id = next(self.ids)
        s.thread = threading.get_ident()
        s.launches = kernels.launch_counts()
        if self.cuda:
            tail = self.local.tail
            s.start_event = (tail[0] if tail is not None
                             and s.parent is not None
                             and tail[1] == s.parent
                             else self._event(top=s.parent is None))
        self.local.tail = None
        stack.append(s)
        self.spans.append(s)
        self.read = None
        s.host_start = time.time_ns()

    def close(self, s: _Span) -> None:
        s.host_end = time.time_ns()
        stack = self._stack()
        if s in stack:
            stack.remove(s)
        before = s.launches
        s.launches = {k: v - before[k]
                      for k, v in kernels.launch_counts().items()
                      if v != before.get(k, 0)}
        if self.cuda and s.start_event is not None:
            s.end_event = self._event()
            self.local.tail = (s.end_event, s.parent)
        self.read = None

    def records(self) -> list:
        if self.read is not None:
            return self.read
        spans = [s for s in self.spans if s.host_end is not None]
        host = None
        if self.cuda and self.anchors and spans:
            host = self._placement()
        counts = _read_counts(spans)
        out = []
        for s, c in zip(spans, counts):
            d0 = d1 = None
            if host is not None and s.end_event is not None:
                d0, d1 = host(s.start_event), host(s.end_event)
            out.append(Record(s.name, s.id, s.parent, s.thread, s.host_start,
                              s.host_end, d0, d1, s.launches, c))
        self.read = out
        return out

    def _placement(self):
        """The host time of each event of the session. Each anchor (with
        one more taken now) bounds the offset of the host clock from the
        device's timer from below; within each window of ``WINDOW_NS`` the
        largest bound is the closest, and the offset is interpolated
        between those. The timer drifts from the host clock unevenly (on
        an H100 a line through a traced span's first anchor and one taken
        ~100 s later put its middle up to 0.8 ms off), and single anchors
        land late by up to hundreds of µs."""
        end = self._event_object()
        points = self.anchors + [(end, anchor(end))]
        self.pool.append(end)
        # Device ns of each anchor after the first, over short steps.
        dev = [0.0]
        for (a, _), (b, _) in zip(points, points[1:]):
            dev.append(dev[-1] + 1e6 * a.elapsed_time(b))
        best = {}
        for d, (_, ns) in zip(dev, points):
            w = int(d // WINDOW_NS)
            if w not in best or ns - d > best[w][1]:
                best[w] = (d, ns - d)
        knots = sorted(best.values())
        at = [k[0] for k in knots]

        def host(ev):
            k = self.segment[id(ev)]
            d = dev[k] + 1e6 * points[k][0].elapsed_time(ev)
            i = bisect.bisect_right(at, d)
            if i == 0 or i == len(knots):
                return d + knots[min(i, len(knots) - 1)][1]
            (d0, o0), (d1, o1) = knots[i - 1], knots[i]
            return d + o0 + (o1 - o0) * (d - d0) / (d1 - d0)
        return host


def _read_counts(spans) -> list:
    """Each span's {name: sum of its values}, with the kept tensors read
    in one transfer per device and dtype."""
    kept = {}
    for s in spans:
        for vals in s.counts.values():
            for v in vals:
                if isinstance(v, torch.Tensor):
                    kept.setdefault((v.device, v.dtype), []).append(v)
    value = {}
    for ts in kept.values():
        for t, x in zip(ts, torch.stack([t.detach().reshape(())
                                         for t in ts]).tolist()):
            value[id(t)] = x
    return [{name: sum(value[id(v)] if isinstance(v, torch.Tensor) else v
                       for v in vals)
             for name, vals in s.counts.items()} for s in spans]


_REC = _Recorder()


def span(name: str):
    """A context manager that records the block as span `name` while a
    profiler records, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    _REC.live = False
    return OFF


def count(name: str, value) -> None:
    """Add `value` (an int, or a one-element tensor kept unread) to count
    `name` of the innermost open span, while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    stack = getattr(_REC.local, "stack", None)
    if stack:
        stack[-1].counts.setdefault(name, []).append(value)


def records() -> list:
    """The closed spans of the last session as :class:`Record`, in the
    order they opened. Waits for the device once, to read the boundary
    events and the kept counts."""
    return _REC.records()


def chrome_events(base_ns: int = 0) -> list:
    """The records as chrome-trace events with timestamps in µs after
    `base_ns`: an ``X`` event per span on the host track (its id, parent,
    launches and counts as arguments) and one per device interval on the
    device track, a thread of each track per host thread."""
    events = [{"ph": "M", "name": "process_name", "pid": pid,
               "args": {"name": name}}
              for pid, name in ((HOST_PID, "program spans"),
                                (DEVICE_PID, "program spans (device)"))]
    tids = {}
    for r in records():
        tid = tids.setdefault(r.thread, len(tids))
        args = {"id": r.id, "parent": r.parent, **r.counts}
        if r.launches:
            args["launches"] = r.launches
        events.append({"ph": "X", "cat": "program", "name": r.name,
                       "pid": HOST_PID, "tid": tid,
                       "ts": (r.host_start - base_ns) / 1e3,
                       "dur": (r.host_end - r.host_start) / 1e3,
                       "args": args})
        if r.device_start is not None:
            events.append({"ph": "X", "cat": "program", "name": r.name,
                           "pid": DEVICE_PID, "tid": tid,
                           "ts": (r.device_start - base_ns) / 1e3,
                           "dur": (r.device_end - r.device_start) / 1e3,
                           "args": {"id": r.id}})
    return events
