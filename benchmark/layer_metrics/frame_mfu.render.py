"""The whole frame's float32 operations (``benchmark/counts``) over the
frames' wall time at the card's float32 peak."""

from benchmark import counts


def read(r):
    if r.span is None or not r.units or r.span.wall_s <= 0:
        return None
    ops = r.total(counts.frame_ops)
    if ops <= 0:
        return None
    return 100.0 * ops / (r.span.wall_s * counts.PEAK_F32_OPS_PER_S)
