"""Operations and bytes of the counted kernels and of whole steps and
frames, as functions of the inputs, with the card's published peaks.

The quantities they take (kept evaluations, needed pairs, visible
Gaussians) are counted by :func:`view_stats` with the benchmark's own plain
projection and binning (``benchmark/reference``), never read from the
measured program: a change to the program leaves them as they are.

An evaluation is counted where the inputs need it: a (pixel, pair) whose
alpha reaches 1/255 before the pixel's stop. A pair is counted where some
pixel of its tile keeps it. Each input byte is counted once, each output
byte written once. These are lower bounds of the work, so a share of the
roofline computed from them cannot pass 100 % unless a time leaves work
out.
"""

from __future__ import annotations

import torch

from ..reference import render as rr

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 outside the
# tensor cores (the step is float32 on the SIMT pipes). Both assume the
# full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# Per (pixel, kept pair): the compositor's evaluation (offset, quadratic
# form, exp, alpha, transmittance, colour and depth accumulation).
K2_OPS_PER_KEPT = 20
# K3 repeats the evaluation and adds the gradient of each input.
K3_OPS_PER_KEPT = 20 + 47
TABLE_ROW_BYTES = 10 * 4          # mean, conic, opacity, rgb, inverse depth
K2_PIXEL_BYTES = (3 + 1 + 1 + 1) * 4   # colour, inverse depth, T, count out
K3_PIXEL_BYTES = (3 + 1 + 1 + 3 + 1 + 1 + 1) * 4  # 5 cotangents and 5 forward
#                                        values in, the count out
RANGE_BYTES = 2 * 4               # a tile's first and last pair

# Per visible Gaussian: projection (covariance, EWA Jacobian, conic,
# radius, pixel mean) and SH degree 3 colour; the backward about twice.
PROJECT_OPS = 405
PROJECT_BWD_OPS = 810
# Per pixel and channel: L1 (forward 3, backward 2) and SSIM (five
# 11 + 11-tap blurs and the map, forward 240, backward 250).
L1_OPS = 5
SSIM_OPS = 490
# Per pixel: the depth-L1 term, forward and backward.
DEPTH_OPS = 5
# Per parameter: Adam with bias correction; per Gaussian the
# densification statistics.
ADAM_OPS = 14
STATS_OPS = 6


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


def k2(s: dict) -> tuple[float, float]:
    """(ops, bytes) of the forward compositor over one view's stats."""
    return (K2_OPS_PER_KEPT * s["kept"],
            TABLE_ROW_BYTES * s["needed_pairs"] + RANGE_BYTES * s["tiles"]
            + K2_PIXEL_BYTES * s["pixels"])


def k3(s: dict) -> tuple[float, float]:
    """(ops, bytes) of the compositor's backward: the table in, its
    gradient out."""
    return (K3_OPS_PER_KEPT * s["kept"],
            2 * TABLE_ROW_BYTES * s["needed_pairs"] + RANGE_BYTES * s["tiles"]
            + K3_PIXEL_BYTES * s["pixels"])


def frame_ops(s: dict) -> float:
    """f32 operations of one rendered frame."""
    return PROJECT_OPS * s["visible"] + K2_OPS_PER_KEPT * s["kept"]


def step_ops(s: dict, params: int, gaussians: int, depth: bool) -> float:
    """f32 operations of one training step."""
    per_pixel = 3 * (L1_OPS + SSIM_OPS) + (DEPTH_OPS if depth else 0)
    return ((PROJECT_OPS + PROJECT_BWD_OPS) * s["visible"]
            + K3_OPS_PER_KEPT * s["kept"] + K2_OPS_PER_KEPT * s["kept"]
            + per_pixel * s["pixels"] + ADAM_OPS * params
            + STATS_OPS * gaussians)


def view_stats(params: dict, view: dict, sh_degree: int = 3) -> dict:
    """Kept evaluations, needed pairs, visible Gaussians, pixels and tiles
    of one view of the store `params`."""
    with torch.no_grad():
        proj = rr.project(params, view, sh_degree)
        pairs = rr.tile_pairs(proj["attrs"], proj["depth"], proj["radius"],
                              view["width"], view["height"])
        bg = torch.zeros(3, device=proj["attrs"].device)
        out = rr.render(proj["attrs"], pairs, view["width"], view["height"],
                        bg)
    gx, gy = pairs["grid"]
    return {"kept": int(out["kept"].sum()),
            "needed_pairs": out["needed_pairs"],
            "visible": int(proj["visible"].sum()),
            "pixels": view["width"] * view["height"], "tiles": gx * gy,
            "rect_pairs": int(pairs["gid"].shape[0])}
