"""Busy device ms a step of the work the program's ``step.adam`` span
launched (learning rates and the Adam update of every group), over the
traced span's steps; the device's idle time is not in it."""

from benchmark import spans


def read(r):
    return spans.busy_ms_per_unit(r, "step", "step.adam")
