"""Device ms a frame of the program's ``render.bin`` span (attribute
packing, depth sort, K1, tile sort, K5a): the interval between its boundary
events, over the traced span's frames."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_unit(r, "render.bin")
