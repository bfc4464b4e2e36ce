"""Image border handling for the depth stack (copy of the JAX package's
``depth/preprocess.py``; the resize of ``crop_aware_infer`` is PIL's only).

Re-derivation of the reference's black/white-border utilities
(``zoedepth/data/preprocess.py:29-160``): benchmark images
carry registration borders (NYU train = white, test = black) that skew both
training targets and evaluation; these helpers detect the border rectangle
and crop (or crop+reflect-pad) around it.

Semantics match the reference exactly: scan rows/columns inward starting at
`min_border`, stop at the first line whose fraction of near-`value` pixels
drops to `tolerance` or below, never scan past `cut_off`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from PIL import Image


@dataclasses.dataclass
class CropParams:
    top: int
    bottom: int
    left: int
    right: int


def get_border_params(rgb_image: np.ndarray, tolerance: float = 0.1,
                      cut_off: int = 20, value: float = 0,
                      level_diff_threshold: float = 5,
                      channel_axis: int = -1,
                      min_border: int = 5) -> CropParams:
    """Border rectangle of near-`value` pixels (reference preprocess.py:38)."""
    gray = np.mean(rgb_image, axis=channel_axis)
    h, w = gray.shape
    near = np.abs(gray - value) < level_diff_threshold

    def scan(fractions, start, limit, step, cut):
        pos = start
        while fractions[pos] > tolerance and (0 < pos < limit):
            pos += step
            if cut(pos):
                break
        return pos

    row_frac = near.mean(axis=1)
    col_frac = near.mean(axis=0)
    top = scan(row_frac, min_border, h - 1, 1, lambda p: p > cut_off)
    bottom = scan(row_frac, h - min_border, h - 1, -1,
                  lambda p: h - p > cut_off)
    left = scan(col_frac, min_border, w - 1, 1, lambda p: p > cut_off)
    right = scan(col_frac, w - min_border, w - 1, -1,
                 lambda p: w - p > cut_off)
    return CropParams(top, bottom, left, right)


def get_black_border(rgb_image: np.ndarray, **kwargs) -> CropParams:
    """Black-border rect (reference preprocess.py:100)."""
    return get_border_params(rgb_image, value=0, **kwargs)


def get_white_border(rgb_image: np.ndarray, value: float = 255,
                     **kwargs) -> CropParams:
    """White-border rect (reference preprocess.py:82); expects uint8 range."""
    return get_border_params(rgb_image, value=value, **kwargs)


def crop_image(image: np.ndarray, crop: CropParams) -> np.ndarray:
    return image[crop.top:crop.bottom, crop.left:crop.right]


def crop_images(*images: np.ndarray, crop: CropParams):
    return tuple(crop_image(im, crop) for im in images)


def avoid_boundary(image: np.ndarray, depth: np.ndarray):
    """NYU-train white-border handling (reference data_mono.py:324-341):
    crop the white border, reflect-pad the IMAGE back to the original size,
    zero-pad the DEPTH (so padded pixels carry no supervision).

    image: (H, W, 3) uint8-range array; depth: (H, W) float.
    """
    h, w = depth.shape[:2]
    crop = get_white_border(np.asarray(image, dtype=np.uint8))
    pad = ((crop.top, h - crop.bottom), (crop.left, w - crop.right))
    image_c = crop_image(image, crop)
    depth_c = crop_image(depth, crop)
    image_p = np.pad(image_c, pad + ((0, 0),) * (image.ndim - 2),
                     mode="reflect")
    depth_p = np.pad(depth_c, pad, mode="constant", constant_values=0)
    return image_p, depth_p


def crop_aware_infer(infer_fn, image: np.ndarray) -> np.ndarray:
    """Black-border-aware inference (reference zoedepth_trainer.py:113-144):
    crop the black border, infer depth on the crop, bilinearly resize the
    prediction to the crop size, zero-pad back to the full frame.

    `infer_fn(img)` maps (h, w, 3) float [0,1] -> (h, w) depth.
    """
    x_u8 = np.asarray(np.clip(image * 255.0, 0, 255), dtype=np.uint8)
    crop = get_black_border(x_u8)
    cropped = image[crop.top:crop.bottom, crop.left:crop.right]
    pred_c = np.asarray(infer_fn(cropped))
    ch, cw = cropped.shape[:2]
    if pred_c.shape != (ch, cw):
        pred_c = np.asarray(Image.fromarray(pred_c.astype(np.float32))
                            .resize((cw, ch), Image.BILINEAR))
    out = np.zeros(image.shape[:2], dtype=np.float32)
    out[crop.top:crop.bottom, crop.left:crop.right] = pred_c
    return out
