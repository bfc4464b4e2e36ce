"""K3 (the compositor's backward, ``composite_bwd_kernel``): the sum of its
launches' bounds (``benchmark/counts``) over the sum of their device
times."""

from benchmark import counts

MARKER = "composite_bwd_kernel"


def read(r):
    hit = r.span.kernel_seconds(MARKER) if r.span is not None else None
    if hit is None or hit[0] <= 0:
        return None
    bound = r.total(lambda s: counts.bound_s(*counts.k3(s)))
    return 100.0 * bound / hit[0] if bound > 0 else None
