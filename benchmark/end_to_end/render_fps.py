"""Frames rendered and copied to the host over the window's seconds."""


def read(r):
    if r.kind != "render" or r.window_s <= 0:
        return None
    return r.units / r.window_s
