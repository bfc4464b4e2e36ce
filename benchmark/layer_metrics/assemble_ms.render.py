"""Device ms a frame of the program's ``render.assemble`` span (tiles to
image, background, exposure, clamp): the interval between its boundary
events, over the traced span's frames."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_unit(r, "render.assemble")
