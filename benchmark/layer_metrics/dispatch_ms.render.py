"""Host wall ms a frame of the program's ``eval`` span: its whole dispatch
of a frame, Python included, over the traced span's frames."""

from benchmark import spans


def read(r):
    return spans.host_ms_per_unit(r, "eval", "eval")
