"""Share of the binning's rect pairs that survive its cull: 100 x Σ
``pairs.valid`` / Σ ``pairs.rect`` of the program's ``render.bin`` spans
over the traced span's frames."""

from benchmark import spans


def read(r):
    valid = spans.count_total(r, "eval", "render.bin", "pairs.valid")
    rect = spans.count_total(r, "eval", "render.bin", "pairs.rect")
    if valid is None or not rect:
        return None
    return 100.0 * valid / rect
