"""K2 (the forward compositor, ``composite_fwd_kernel``): the sum of its
launches' bounds (``benchmark/counts``) over the sum of their device
times."""

from benchmark import counts

MARKER = "composite_fwd_kernel"


def read(r):
    hit = r.span.kernel_seconds(MARKER) if r.span is not None else None
    if hit is None or hit[0] <= 0:
        return None
    bound = r.total(lambda s: counts.bound_s(*counts.k2(s)))
    return 100.0 * bound / hit[0] if bound > 0 else None
