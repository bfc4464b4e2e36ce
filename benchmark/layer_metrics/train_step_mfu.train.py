"""The whole step's float32 operations (``benchmark/counts``) over the
step's wall time at the card's float32 peak."""

from benchmark import counts


def read(r):
    if r.span is None or not r.units or r.span.wall_s <= 0:
        return None
    cfg = r.cfg
    n = cfg["gaussians"]
    params = n * (3 * (cfg["sh_degree"] + 1) ** 2 + 11)
    depth = bool(cfg["depth_prior"] and cfg["depth_feedback"])
    ops = r.total(lambda s: counts.step_ops(s, params, n, depth))
    if ops <= 0:
        return None
    return 100.0 * ops / (r.span.wall_s * counts.PEAK_F32_OPS_PER_S)
