"""95th percentile (nearest rank) over every frame of the window, each timed
from its dispatch to its uint8 image on the host, in ms."""

from benchmark.drivers import percentile


def read(r):
    if r.kind != "render" or not r.latencies:
        return None
    return 1e3 * percentile(r.latencies, 95)
