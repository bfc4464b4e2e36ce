"""Host wall ms a step of the program's ``step`` span: its whole dispatch of
a step, Python included, over the traced span's steps."""

from benchmark import spans


def read(r):
    return spans.host_ms_per_unit(r, "step", "step")
