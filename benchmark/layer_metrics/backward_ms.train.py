"""Busy device ms a step of the work the program's ``step.backward`` span
launched (autograd through the loss, K3, K5b, K4 and the projection's
glue, the autograd engine's launches included), over the traced span's
steps; the device's idle time is not in it."""

from benchmark import spans


def read(r):
    return spans.busy_ms_per_unit(r, "step", "step.backward")
