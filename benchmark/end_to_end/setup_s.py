"""Process start to the first timed iteration or frame."""


def read(r):
    return r.setup_s
