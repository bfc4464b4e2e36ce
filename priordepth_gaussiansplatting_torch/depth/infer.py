"""Depth inference with the reference's test-time augmentation chain
(counterpart of the JAX package's ``depth/infer.py``;
``zoedepth/models/depth_model.py:35-151``): reflect-pad augmentation and
horizontal-flip averaging, PIL in, 16-bit inverse-depth PNG out. It makes
the depth priors that the splatting trainer reads (``-d depths``).

The functions take a depth module (``depth/model.py``) and run it under
``torch.inference_mode()`` on the card, unless the caller names the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image
from torch import nn

from ..device import resolve_device


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of numpy's "reflect" padding of an axis of `n` by
    (lo, hi); pads longer than the axis reflect again, as numpy's do."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i > n - 1, period - i, i)


def infer_with_tta(model: nn.Module, image: torch.Tensor,
                   pad_frac: float = 0.03, with_flip: bool = True,
                   multiple_of: int = 32) -> torch.Tensor:
    """image: (B, H, W, 3) in [0, 1] on the model's device -> (B, H, W)
    metric depth. Each side is reflect-padded by at least `multiple_of`
    pixels, the total rounded up to a multiple of it (ViT patching); with
    `with_flip` the depth of the mirrored image is averaged in."""
    b, h, w, _ = image.shape
    ph = max(int(np.sqrt(h / 2) * pad_frac * h), multiple_of)
    pw = max(int(np.sqrt(w / 2) * pad_frac * w), multiple_of)
    th = (-(-(h + 2 * ph) // multiple_of)) * multiple_of
    tw = (-(-(w + 2 * pw) // multiple_of)) * multiple_of
    iy = _reflect_index(h, ph, th - h - ph, image.device)
    ix = _reflect_index(w, pw, tw - w - pw, image.device)
    with torch.inference_mode():
        padded = image.permute(0, 3, 1, 2)[:, :, iy][:, :, :, ix]
        depth = model(padded)["metric_depth"]
        if with_flip:
            flipped = model(padded.flip(-1))["metric_depth"]
            depth = 0.5 * (depth + flipped.flip(-1))
        return depth[:, ph:ph + h, pw:pw + w]


def infer_pil(model: nn.Module, pil_image: Image.Image, device=None,
              **kw) -> np.ndarray:
    """(H, W) metric depth of a PIL image, by :func:`infer_with_tta` on
    `device` (the card unless the caller names the CPU), where the model
    is moved."""
    device = resolve_device(device)
    model = model.to(device).eval()
    arr = np.asarray(pil_image.convert("RGB"), np.float32) / 255.0
    depth = infer_with_tta(model, torch.from_numpy(arr)[None].to(device),
                           **kw)
    return depth[0].cpu().numpy()


def save_invdepth_png(path: str, depth: np.ndarray,
                      eps: float = 1e-6) -> None:
    """16-bit inverse-depth PNG, the format the splatting data loader and
    depth-scale tool consume (``utils/camera_utils.py:26-28``)."""
    inv = 1.0 / np.maximum(depth, eps)
    inv = inv / max(inv.max(), eps)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((inv * 65535.0).astype(np.uint16)).save(path)


def generate_depth_priors(model: nn.Module, images_dir: str, out_dir: str,
                          device=None) -> list:
    """The DepthAnythingV2 ``run.py`` batch job: images/ -> 16-bit
    inverse-depth PNGs named like the inputs (``train_image.py:15``), on
    `device` (the card unless the caller names the CPU). Returns the
    written paths."""
    device = resolve_device(device)
    written = []
    for name in sorted(os.listdir(images_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        with Image.open(os.path.join(images_dir, name)) as im:
            depth = infer_pil(model, im, device=device)
        out = os.path.join(out_dir, stem + ".png")
        save_invdepth_png(out, depth)
        written.append(out)
    return written
