"""Busy device ms a step of the work the program's ``step.loss`` span
launched (L1, SSIM, the depth term), over the traced span's steps; the
device's idle time is not in it."""

from benchmark import spans


def read(r):
    return spans.busy_ms_per_unit(r, "step", "step.loss")
