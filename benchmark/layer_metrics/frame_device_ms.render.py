"""Device time of a frame: the union of the span's device intervals over
its frames."""


def read(r):
    if r.span is None or not r.units:
        return None
    return 1e3 * r.span.busy_s / r.units
