"""Training observability (a copy of the JAX package's ``utils/logging.py``
for tensors): a JSONL event log with the reference's TensorBoard scalar
names, rendered images as PNGs under ``tb_images/``, histograms, optional
TensorBoard pass-through when the package exists, and ``safe_state``'s
seeding (reference ``utils/general_utils.py:112-133``)."""

from __future__ import annotations

import json
import os
import random
import time

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MetricsLogger:
    """Scalars -> <model_path>/events.jsonl (+ TensorBoard if available)."""

    def __init__(self, model_path: str):
        self.path = os.path.join(model_path, "events.jsonl") \
            if model_path else ""
        if model_path:
            os.makedirs(model_path, exist_ok=True)
        self._fh = open(self.path, "a") if self.path else None
        self._tb = None
        self._image_warned = False
        if model_path:
            try:
                from torch.utils.tensorboard import SummaryWriter  # noqa
                self._tb = SummaryWriter(model_path)
            except Exception:
                self._tb = None

    def _write(self, record: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(dict(record, ts=time.time())) + "\n")
            self._fh.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step)})
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, values: dict, step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def image(self, tag: str, img, step: int) -> None:
        """A (3, H, W) image in [0, 1] (reference ``train.py:421-427``):
        TensorBoard gets it natively; a PNG is written under
        <model_path>/tb_images/ and its path recorded in the JSONL."""
        img = _numpy(img)
        if self._tb is not None:
            self._tb.add_images(tag, img[None], global_step=step)
        if not self.path:
            return
        out_dir = os.path.join(os.path.dirname(self.path), "tb_images")
        os.makedirs(out_dir, exist_ok=True)
        safe = tag.replace("/", "_").replace(" ", "_")
        fname = os.path.join(out_dir, f"{safe}_{step}.png")
        arr = np.transpose((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8),
                           (1, 2, 0))
        try:
            from PIL import Image  # noqa: PLC0415
            Image.fromarray(arr).save(fname)
        except Exception as e:
            if not self._image_warned:
                self._image_warned = True
                print(f"[logging] image save failed for {fname}: {e} "
                      "(further image-save failures silenced)", flush=True)
            return
        self._write({"tag": tag, "image": fname, "step": int(step)})

    def histogram(self, tag: str, values, step: int, bins: int = 64) -> None:
        """Bin counts and edges of the finite values (reference
        ``train.py:441``, the opacity histogram)."""
        values = _numpy(values).reshape(-1)
        finite = values[np.isfinite(values)]
        if self._tb is not None and finite.size:
            self._tb.add_histogram(tag, finite, global_step=step)
        counts, edges = (np.histogram(finite, bins=bins) if finite.size
                         else (np.zeros(bins, np.int64), np.zeros(bins + 1)))
        self._write({"tag": tag, "step": int(step),
                     "hist": {"counts": counts.tolist(),
                              "lo": float(edges[0]), "hi": float(edges[-1]),
                              "mean": float(finite.mean()) if finite.size
                              else 0.0,
                              "n": int(finite.size)}})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def safe_state(seed: int = 0) -> None:
    """Seed Python's, numpy's and torch's generators (where the JAX package
    seeds Python's and numpy's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
