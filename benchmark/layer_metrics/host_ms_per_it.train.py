"""Host time of dispatching a step: the main thread's profiled self time,
less the calls that wait for the device, over the span's iterations."""


def read(r):
    if r.span is None or not r.units:
        return None
    return 1e3 * r.span.host_s / r.units
