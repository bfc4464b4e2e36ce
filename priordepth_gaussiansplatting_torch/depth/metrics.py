"""Depth-evaluation metrics with eigen/garg crops (copy of the JAX
package's ``depth/metrics.py``; reference ``zoedepth/utils/misc.py:159-246``).
``evaluate_dataset`` runs the port's depth module on a device."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .infer import infer_with_tta
from .preprocess import crop_aware_infer


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> dict:
    """a1/a2/a3, abs_rel, sq_rel, rmse, rmse_log, log_10, silog over valid
    (already-masked/flattened) arrays."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25 ** 2).mean())
    a3 = float((thresh < 1.25 ** 3).mean())
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))
    rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))
    err = np.log(pred) - np.log(gt)
    # Variance clamped at 0: float cancellation can drive E[e^2]-E[e]^2
    # fractionally negative for near-constant errors, which NaN'd silog.
    silog = float(
        np.sqrt(max(np.mean(err ** 2) - np.mean(err) ** 2, 0.0)) * 100)
    log_10 = float(np.mean(np.abs(np.log10(gt) - np.log10(pred))))
    return dict(a1=a1, a2=a2, a3=a3, abs_rel=abs_rel, rmse=rmse,
                log_10=log_10, rmse_log=rmse_log, silog=silog,
                sq_rel=sq_rel)


def compute_metrics(gt: np.ndarray, pred: np.ndarray,
                    min_depth_eval: float = 1e-3,
                    max_depth_eval: float = 10.0,
                    crop: str | None = None,
                    garg_crop: bool = False,
                    eigen_crop: bool = False) -> dict:
    """Clamp, crop (garg/eigen), mask and compute errors
    (`misc.py:200-246`)."""
    pred = pred.squeeze()
    gt = gt.squeeze()
    pred = np.clip(pred, min_depth_eval, max_depth_eval)
    pred[np.isinf(pred)] = max_depth_eval
    pred[np.isnan(pred)] = min_depth_eval
    valid = (gt > min_depth_eval) & (gt < max_depth_eval)
    if garg_crop or eigen_crop or crop in ("garg", "eigen"):
        gh, gw = gt.shape
        eval_mask = np.zeros_like(valid)
        if garg_crop or crop == "garg":
            eval_mask[int(0.40810811 * gh):int(0.99189189 * gh),
                      int(0.03594771 * gw):int(0.96405229 * gw)] = 1
        else:
            eval_mask[int(0.3324324 * gh):int(0.91351351 * gh),
                      int(0.0359477 * gw):int(0.96405229 * gw)] = 1
        valid &= eval_mask.astype(bool)
    return compute_errors(gt[valid], pred[valid])


class RunningAverageDict:
    """Streaming metric averages (`misc.py:74-95`)."""

    def __init__(self):
        self._sums: dict = {}
        self._count = 0

    def update(self, new: dict) -> None:
        self._count += 1
        for k, v in new.items():
            self._sums[k] = self._sums.get(k, 0.0) + v

    def get_value(self) -> dict:
        return {k: v / max(self._count, 1) for k, v in self._sums.items()}


def evaluate_dataset(model, dataset, preset: dict, device=None,
                     use_tta: bool = True, limit: int | None = None,
                     avoid_boundary: bool = False) -> dict:
    """Run a port depth module over an eval dataset with the preset's caps
    and crop (the reference ``BaseTrainer.validate`` + compute_metrics
    loop), on `device` (the card unless the caller names the CPU), where
    the module is moved. One image at a time, with the TTA of
    ``infer.infer_with_tta`` unless `use_tta` is off.

    With `avoid_boundary`, inference is black-border-aware: the frame's
    black registration border is cropped before inference and the
    prediction zero-padded back (reference zoedepth_trainer.py:113-144
    ``crop_aware_infer``)."""
    device = resolve_device(device)
    model = model.to(device).eval()

    def infer(img):
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        x = x[None].to(device)
        if use_tta:
            depth = infer_with_tta(model, x)
        else:
            with torch.inference_mode():
                depth = model(x.permute(0, 3, 1, 2))["metric_depth"]
        return depth[0].cpu().numpy()

    ra = RunningAverageDict()
    n = len(dataset) if limit is None else min(limit, len(dataset))
    for i in range(n):
        s = dataset[i]
        image = np.asarray(s.image)
        pred = (crop_aware_infer(infer, image) if avoid_boundary
                else infer(image))
        ra.update(compute_metrics(
            np.asarray(s.depth), pred,
            min_depth_eval=preset.get("min_depth_eval", 1e-3),
            max_depth_eval=preset.get("max_depth_eval", 10.0),
            garg_crop=preset.get("garg_crop", False),
            eigen_crop=preset.get("eigen_crop", False)))
    return ra.get_value()


def colorize(value, vmin=None, vmax=None, cmap: str = "magma_r",
             invalid_val=-99, invalid_mask=None,
             background_color=(128, 128, 128, 255),
             gamma_corrected: bool = False, value_transform=None):
    """Depth map -> uint8 RGBA colour image for experiment logging.

    Re-derivation of the reference's `zoedepth/utils/misc.py:97` colorize:
    percentile normalisation (2%/85%) over valid pixels, matplotlib
    colormap, grey background for invalid pixels, optional gamma. Returns
    (H, W, 4) uint8.
    """
    value = np.asarray(value, dtype=np.float32).squeeze()
    if invalid_mask is None:
        invalid_mask = value == invalid_val
    mask = ~invalid_mask
    if mask.any():
        vmin = np.percentile(value[mask], 2) if vmin is None else vmin
        vmax = np.percentile(value[mask], 85) if vmax is None else vmax
    else:
        vmin, vmax = 0.0, 1.0
    value = ((value - vmin) / (vmax - vmin)) if vmin != vmax else value * 0.0
    value = np.where(mask, value, np.nan)
    try:
        import matplotlib.cm  # noqa: PLC0415
        img = matplotlib.cm.get_cmap(cmap)(
            value_transform(value) if value_transform else value, bytes=True)
    except Exception:  # grayscale fallback without matplotlib
        g = np.clip(np.nan_to_num(value), 0.0, 1.0)
        if cmap.endswith("_r"):
            g = 1.0 - g
        g8 = (g * 255).astype(np.uint8)
        img = np.stack([g8, g8, g8, np.full_like(g8, 255)], axis=-1)
    img[invalid_mask] = background_color
    if gamma_corrected:
        img = ((img / 255.0) ** 2.2 * 255).astype(np.uint8)
    return img
