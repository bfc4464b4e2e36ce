"""Share of the traced span's wall time in which the device ran nothing."""


def read(r):
    if r.span is None or r.span.wall_s <= 0:
        return None
    return 100.0 * (1.0 - r.span.busy_s / r.span.wall_s)
