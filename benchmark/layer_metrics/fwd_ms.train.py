"""Busy device ms a step of the work the program's ``render`` span inside
``step`` launched (the forward: projection with autograd recording,
binning, K2, assembly), over the traced span's steps; the device's idle
time is not in it."""

from benchmark import spans


def read(r):
    return spans.busy_ms_per_unit(r, "step", "render")
