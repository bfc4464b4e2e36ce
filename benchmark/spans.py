"""The program's own spans of the traced span, for the readers of the
``program_span`` and ``program_counter`` metrics: the records of
``priordepth_gaussiansplatting_torch/utils/tracing.py`` (its host
intervals on the profiler's clock, its device intervals between its
boundary events, its counts). A program without that module, or a session
that does not hold exactly one ``eval`` span a unit of the traced span,
reads as None.
"""

from __future__ import annotations


def session(r):
    """The records of the traced span, or None."""
    if r.span is None or not r.units:
        return None
    try:
        from priordepth_gaussiansplatting_torch.utils import tracing
    except ImportError:
        return None
    recs = tracing.records()
    if sum(x.name == "eval" for x in recs) != r.units:
        return None
    return recs


def device_ms_per_unit(r, name: str):
    """Σ device ms of the spans `name` over the traced span's units."""
    recs = session(r)
    ms = [] if recs is None else [x.device_ms for x in recs
                                  if x.name == name]
    if not ms or None in ms:
        return None
    return sum(ms) / r.units


def host_ms_per_unit(r, name: str):
    """Σ host ms of the spans `name` over the traced span's units."""
    recs = session(r)
    ms = [] if recs is None else [x.host_ms for x in recs if x.name == name]
    return sum(ms) / r.units if ms else None


def count_total(r, span: str, name: str):
    """Σ of count `name` over the spans `span`, or None where none holds
    it."""
    recs = session(r)
    got = [] if recs is None else [x.counts[name] for x in recs
                                   if x.name == span and name in x.counts]
    return sum(got) if got else None
