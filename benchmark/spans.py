"""The program's own spans of the traced span, for the readers of the
``program_span`` and ``program_counter`` metrics: the records of
``priordepth_gaussiansplatting_torch/utils/tracing.py`` (its host
intervals on the profiler's clock, its device intervals between its
boundary events, its counts).

Each reader names the span of the program that is one unit of its
reading: ``eval`` a rendered frame, ``step`` a training iteration. A
program without that module, or a session that does not hold exactly one
unit span a unit of the traced span, reads as None; and only the unit
spans and the spans inside them are read.
"""

from __future__ import annotations

import bisect


def session(r, unit: str):
    """The records of the traced span, or None."""
    if r.span is None or not r.units:
        return None
    try:
        from priordepth_gaussiansplatting_torch.utils import tracing
    except ImportError:
        return None
    recs = tracing.records()
    if sum(x.name == unit for x in recs) != r.units:
        return None
    return recs


def in_units(r, unit: str, name: str) -> list:
    """The spans `name` that are `unit` spans or lie inside one."""
    recs = session(r, unit)
    if recs is None:
        return []
    parent = {x.id: x.parent for x in recs}
    units = {x.id for x in recs if x.name == unit}

    def inside(i):
        while i is not None and i not in units:
            i = parent.get(i)
        return i is not None

    return [x for x in recs if x.name == name and inside(x.id)]


def device_ms_per_unit(r, unit: str, name: str):
    """Σ device ms of the spans `name` over the traced span's units: the
    intervals between their boundary events, the device's idle time inside
    them included."""
    ms = [x.device_ms for x in in_units(r, unit, name)]
    if not ms or None in ms:
        return None
    return sum(ms) / r.units


def busy_ms_per_unit(r, unit: str, name: str):
    """Busy device ms a unit of the work the spans `name` launched: the
    union of the profiler's device intervals of the operations whose launch
    the host made while one of those spans was open (on any thread, so
    that the autograd engine's launches count to the span that waits for
    them), wherever the device ran them. The device's idle time is not in
    it. None where some device operation of the traced span had no launch
    to match, since its work could belong to any span."""
    got = in_units(r, unit, name)
    if not got or not r.span.launched or r.span.unlinked:
        return None
    ops = r.span.launched
    launches = [o[0] for o in ops]
    dev = []
    for x in got:
        lo = bisect.bisect_left(launches, x.host_start)
        hi = bisect.bisect_right(launches, x.host_end)
        dev.extend(o[1:] for o in ops[lo:hi])
    busy, end = 0, None
    for s, e in sorted(dev):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6 / r.units


def host_ms_per_unit(r, unit: str, name: str):
    """Σ host ms of the spans `name` over the traced span's units."""
    ms = [x.host_ms for x in in_units(r, unit, name)]
    return sum(ms) / r.units if ms else None


def count_total(r, unit: str, span: str, name: str):
    """Σ of count `name` over the spans `span`, or None where none holds
    it."""
    got = [x.counts[name] for x in in_units(r, unit, span) if name in x.counts]
    return sum(got) if got else None
