"""Training iterations completed in the window over the window's seconds."""


def read(r):
    if r.kind != "train" or r.window_s <= 0:
        return None
    return r.units / r.window_s
