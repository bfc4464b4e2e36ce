"""Depth-training data pipeline (copy of the JAX package's
``depth/data.py``, numpy and PIL only; reference
``zoedepth/data/data_mono.py``).

Folder-based RGB+depth datasets with the reference's train augmentations
(random rotate / crop / horizontal flip / gamma / brightness / colour,
`DataLoadPreprocess`, data_mono.py:270-509), round-robin dataset mixing
(`MixedNYUKITTI`), and per-host batch sharding in place of torch's
DistributedSampler: every host reads its `host_index`-strided subset of
one permutation. Batches are NHWC numpy arrays; the depth trainer moves
them to its device and lays them out for the model.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image


@dataclasses.dataclass
class DepthSample:
    image: np.ndarray   # (H, W, 3) float32 [0, 1]
    depth: np.ndarray   # (H, W) float32 metric depth
    mask: np.ndarray    # (H, W) bool


@dataclasses.dataclass
class AugmentConfig:
    """Reference train-time augmentations (data_mono.py:286-413)."""

    do_random_rotate: bool = True
    degree: float = 2.5
    do_flip: bool = True
    do_color_aug: bool = True
    gamma_range: tuple = (0.9, 1.1)
    brightness_range: tuple = (0.9, 1.1)
    color_range: tuple = (0.9, 1.1)
    crop_h: int = 416
    crop_w: int = 544


def _rotate(arr: np.ndarray, angle_deg: float, bilinear: bool) -> np.ndarray:
    im = Image.fromarray(arr if arr.ndim == 3 else arr.astype(np.float32))
    resample = (Image.Resampling.BILINEAR if bilinear
                else Image.Resampling.NEAREST)
    return np.asarray(im.rotate(angle_deg, resample=resample))


def augment(sample: DepthSample, cfg: AugmentConfig,
            rng: random.Random) -> DepthSample:
    img, depth, mask = sample.image, sample.depth, sample.mask
    if cfg.do_random_rotate:
        angle = rng.uniform(-cfg.degree, cfg.degree)
        img = _rotate((img * 255).astype(np.uint8), angle, True) / 255.0
        depth = _rotate(depth, angle, False)
        mask = _rotate(mask.astype(np.float32), angle, False) > 0.5
    h, w = depth.shape
    ch, cw = min(cfg.crop_h, h), min(cfg.crop_w, w)
    y = rng.randint(0, h - ch) if h > ch else 0
    x = rng.randint(0, w - cw) if w > cw else 0
    img = img[y:y + ch, x:x + cw]
    depth = depth[y:y + ch, x:x + cw]
    mask = mask[y:y + ch, x:x + cw]
    if cfg.do_flip and rng.random() > 0.5:
        img = img[:, ::-1]
        depth = depth[:, ::-1]
        mask = mask[:, ::-1]
    if cfg.do_color_aug and rng.random() > 0.5:
        img = img ** rng.uniform(*cfg.gamma_range)
        img = img * rng.uniform(*cfg.brightness_range)
        colors = np.array([rng.uniform(*cfg.color_range)
                           for _ in range(3)])
        white = np.ones_like(img)
        img = np.clip(img * (white * colors), 0.0, 1.0)
    return DepthSample(np.ascontiguousarray(img.astype(np.float32)),
                       np.ascontiguousarray(depth.astype(np.float32)),
                       np.ascontiguousarray(mask))


class FolderDepthDataset:
    """Paired `images/` + `depths/` folders; depth PNGs are 16-bit values
    scaled by `depth_scale` (NYU: 1000, KITTI: 256)."""

    def __init__(self, root: str, depth_scale: float = 1000.0,
                 min_depth: float = 1e-3, max_depth: float = 10.0,
                 images_dir: str = "images", depths_dir: str = "depths"):
        self.root = root
        self.depth_scale = depth_scale
        self.min_depth = min_depth
        self.max_depth = max_depth
        img_root = os.path.join(root, images_dir)
        self.names = sorted(
            n for n in os.listdir(img_root)
            if os.path.splitext(n)[1].lower() in (".png", ".jpg", ".jpeg"))
        self.images_dir = img_root
        self.depths_dir = os.path.join(root, depths_dir)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, idx: int) -> DepthSample:
        name = self.names[idx]
        stem = os.path.splitext(name)[0]
        with Image.open(os.path.join(self.images_dir, name)) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
        with Image.open(os.path.join(self.depths_dir, stem + ".png")) as dm:
            depth = np.asarray(dm, np.float32) / self.depth_scale
        mask = (depth > self.min_depth) & (depth < self.max_depth)
        return DepthSample(img, depth, mask)


class MixedDataset:
    """Round-robin mixing of several datasets (reference MixedNYUKITTI,
    data_mono.py:181-238); exposes the source index as the domain label."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def sample(self, rng: random.Random):
        d_idx = rng.randrange(len(self.datasets))
        ds = self.datasets[d_idx]
        return ds[rng.randrange(len(ds))], d_idx


def batches(dataset, batch_size: int, cfg: Optional[AugmentConfig] = None,
            seed: int = 0, host_count: int = 1, host_index: int = 0,
            epochs: int = 1) -> Iterator[dict]:
    """Host-sharded shuffled batch iterator (the DistributedSampler
    equivalent: each host sees its strided subset of the permutation)."""
    rng = random.Random(seed + host_index)
    n = len(dataset)
    for epoch in range(epochs):
        order = list(range(n))
        random.Random(seed + epoch).shuffle(order)   # same across hosts
        local = order[host_index::host_count]
        for i in range(0, len(local) - batch_size + 1, batch_size):
            samples = []
            for j in local[i:i + batch_size]:
                s = dataset[j]
                if cfg is not None:
                    s = augment(s, cfg, rng)
                samples.append(s)
            yield {
                "image": np.stack([s.image for s in samples]),
                "depth": np.stack([s.depth for s in samples]),
                "mask": np.stack([s.mask for s in samples]),
            }


# Per-dataset conventions (reference zoedepth DATASETS_CONFIG /
# data_mono.py dataset registry): depth PNG scale factor, eval depth caps
# and crop. Folder layouts normalise to images/ + depths/.
DATASET_PRESETS = {
    "nyu": dict(depth_scale=1000.0, min_depth=1e-3, max_depth=10.0,
                min_depth_eval=1e-3, max_depth_eval=10.0, eigen_crop=True),
    "kitti": dict(depth_scale=256.0, min_depth=1e-3, max_depth=80.0,
                  min_depth_eval=1e-3, max_depth_eval=80.0, garg_crop=True),
    "ibims": dict(depth_scale=1000.0, min_depth=1e-3, max_depth=10.0,
                  min_depth_eval=0.0, max_depth_eval=50.0, eigen_crop=True),
    "sunrgbd": dict(depth_scale=1000.0, min_depth=1e-3, max_depth=8.0,
                    min_depth_eval=1e-3, max_depth_eval=8.0,
                    eigen_crop=True),
    "diml_indoor": dict(depth_scale=1000.0, min_depth=1e-3, max_depth=10.0,
                        min_depth_eval=1e-3, max_depth_eval=10.0,
                        eigen_crop=True),
    "diml_outdoor": dict(depth_scale=1000.0, min_depth=1e-3,
                         max_depth=80.0, min_depth_eval=2.0,
                         max_depth_eval=80.0, garg_crop=True),
    "diode_indoor": dict(depth_scale=256.0, min_depth=1e-3, max_depth=10.0,
                         min_depth_eval=1e-3, max_depth_eval=10.0,
                         eigen_crop=True),
    "diode_outdoor": dict(depth_scale=256.0, min_depth=1e-3,
                          max_depth=80.0, min_depth_eval=1e-3,
                          max_depth_eval=80.0, garg_crop=True),
    "hypersim": dict(depth_scale=1000.0, min_depth=1e-3, max_depth=10.0,
                     min_depth_eval=1e-3, max_depth_eval=10.0,
                     eigen_crop=True),
    "vkitti2": dict(depth_scale=100.0, min_depth=1e-3, max_depth=80.0,
                    min_depth_eval=1e-3, max_depth_eval=80.0,
                    garg_crop=True),
    "ddad": dict(depth_scale=256.0, min_depth=1e-3, max_depth=80.0,
                 min_depth_eval=1e-3, max_depth_eval=80.0, garg_crop=True),
    "mix": dict(depth_scale=1000.0, min_depth=1e-3, max_depth=80.0),
}


def make_dataset(root: str, preset: str = "nyu", **overrides):
    """Folder dataset with a named per-dataset convention preset."""
    cfg = dict(DATASET_PRESETS[preset])
    cfg.update(overrides)
    return FolderDepthDataset(
        root, depth_scale=cfg["depth_scale"],
        min_depth=cfg["min_depth"], max_depth=cfg["max_depth"])


# --- Concrete dataset layouts (reference zoedepth/data/data_mono.py) -------
#
# The reference trains/evals from "filenames files" — text files whose lines
# are `rgb_rel_path depth_rel_path focal` — resolved against data_path /
# gt_path, with KITTI's kb_crop applied at load (`data_mono.py:270-509`).
# The walkers below additionally discover the standard on-disk layouts
# directly (KITTI raw + depth-annotated, NYUv2 scene folders) so the loaders
# work without the txt indices.


def kb_crop(arr: np.ndarray) -> np.ndarray:
    """KITTI benchmark crop: bottom-centre 352x1216 window
    (`data_mono.py`: top_margin = h-352, left_margin = (w-1216)/2)."""
    h, w = arr.shape[:2]
    top = max(h - 352, 0)
    left = max((w - 1216) // 2, 0)
    return arr[top:top + 352, left:left + 1216]


class TxtSplitDepthDataset:
    """Reference filenames-file dataset: lines `rgb_rel depth_rel [focal]`.

    `data_path`/`gt_path` mirror the reference config fields; `None` depth
    paths (the literal string "None" in eval splits with missing gt) yield
    all-false masks. Set `do_kb_crop` for KITTI conventions."""

    def __init__(self, data_path: str, gt_path: str, filenames_file: str,
                 depth_scale: float = 256.0, min_depth: float = 1e-3,
                 max_depth: float = 80.0, do_kb_crop: bool = False):
        self.data_path = data_path
        self.gt_path = gt_path
        self.depth_scale = depth_scale
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.do_kb_crop = do_kb_crop
        self.entries = []
        with open(filenames_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                rgb = parts[0]
                depth = parts[1] if len(parts) > 1 else "None"
                focal = float(parts[2]) if len(parts) > 2 else 0.0
                self.entries.append((rgb, depth, focal))

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> DepthSample:
        rgb_rel, depth_rel, _ = self.entries[idx]
        with Image.open(os.path.join(self.data_path,
                                     rgb_rel.lstrip("/"))) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
        if depth_rel == "None":
            depth = np.zeros(img.shape[:2], np.float32)
        else:
            with Image.open(os.path.join(self.gt_path,
                                         depth_rel.lstrip("/"))) as dm:
                depth = np.asarray(dm, np.float32) / self.depth_scale
        if self.do_kb_crop:
            img = kb_crop(img)
            depth = kb_crop(depth)
        mask = (depth > self.min_depth) & (depth < self.max_depth)
        return DepthSample(img, depth, mask)


class KittiDepthDataset:
    """KITTI raw + depth-annotated on-disk layout walker.

    rgb:   <root>/<date>/<drive>_sync/image_02/data/<frame>.png
    depth: <gt_root>/<drive>_sync/proj_depth/groundtruth/image_02/<frame>.png
    Depth PNGs are uint16 metres*256; frames without gt are skipped. kb_crop
    applied (KITTI eval convention; garg crop happens at metric time)."""

    def __init__(self, root: str, gt_root: str, min_depth: float = 1e-3,
                 max_depth: float = 80.0, do_kb_crop: bool = True):
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.do_kb_crop = do_kb_crop
        self.pairs = []
        for date in sorted(os.listdir(root)):
            dpath = os.path.join(root, date)
            if not os.path.isdir(dpath):
                continue
            for drive in sorted(os.listdir(dpath)):
                img_dir = os.path.join(dpath, drive, "image_02", "data")
                gt_dir = os.path.join(gt_root, drive, "proj_depth",
                                      "groundtruth", "image_02")
                if not (os.path.isdir(img_dir) and os.path.isdir(gt_dir)):
                    continue
                for fn in sorted(os.listdir(img_dir)):
                    gt = os.path.join(gt_dir, fn)
                    if fn.endswith(".png") and os.path.exists(gt):
                        self.pairs.append((os.path.join(img_dir, fn), gt))

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> DepthSample:
        rgb_p, gt_p = self.pairs[idx]
        with Image.open(rgb_p) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
        with Image.open(gt_p) as dm:
            depth = np.asarray(dm, np.float32) / 256.0
        if self.do_kb_crop:
            img, depth = kb_crop(img), kb_crop(depth)
        mask = (depth > self.min_depth) & (depth < self.max_depth)
        return DepthSample(img, depth, mask)


class NyuDepthDataset:
    """NYUv2 scene-folder layout walker.

    <root>/<scene>/rgb_<k>.jpg + <root>/<scene>/sync_depth_<k>.png, depth
    uint16 metres*1000; the eigen crop happens at metric time."""

    def __init__(self, root: str, min_depth: float = 1e-3,
                 max_depth: float = 10.0, avoid_boundary: bool = False):
        self.min_depth = min_depth
        self.max_depth = max_depth
        # NYU train frames carry a white registration border; with
        # `avoid_boundary` the border is cropped and reflect-padded back
        # (depth zero-padded = unsupervised), matching the reference's
        # data_mono.py:324-341 option.
        self.avoid_boundary = avoid_boundary
        self.pairs = []
        for scene in sorted(os.listdir(root)):
            spath = os.path.join(root, scene)
            if not os.path.isdir(spath):
                continue
            for fn in sorted(os.listdir(spath)):
                if fn.startswith("rgb_"):
                    stem = os.path.splitext(fn[len("rgb_"):])[0]
                    gt = os.path.join(spath, f"sync_depth_{stem}.png")
                    if os.path.exists(gt):
                        self.pairs.append((os.path.join(spath, fn), gt))

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> DepthSample:
        rgb_p, gt_p = self.pairs[idx]
        with Image.open(rgb_p) as im:
            img8 = np.asarray(im.convert("RGB"), np.uint8)
        with Image.open(gt_p) as dm:
            depth = np.asarray(dm, np.float32) / 1000.0
        if self.avoid_boundary:
            from .preprocess import avoid_boundary as _ab  # noqa: PLC0415
            img8, depth = _ab(img8, depth)
        img = img8.astype(np.float32) / 255.0
        mask = (depth > self.min_depth) & (depth < self.max_depth)
        return DepthSample(img, depth, mask)


# --- Per-dataset EVAL loaders (reference zoedepth/data/{ibims,
# sun_rgbd_loader, diml_indoor_test, diml_outdoor_test, diode, hypersim,
# vkitti, vkitti2, ddad}.py) -------------------------------------------------
#
# Each walks the dataset's published on-disk layout and yields DepthSamples
# with the reference's unit conversions and validity conventions; metric-time
# caps/crops come from DATASET_PRESETS. Invalid pixels are encoded exactly as
# the reference does (depth <= 0 -> masked).


def _imread(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _mask_of(depth: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return (depth > lo) & (depth < hi)


class IbimsDataset:
    """iBims-1 layout (`ibims.py:35-69`): imagelist.txt names; rgb/<b>.png,
    depth/<b>.png (uint16 * 50 / 65535 metres), mask_invalid/ + mask_transp/
    binary PNGs; invalid pixels get depth -1."""

    def __init__(self, root: str, min_depth: float = 1e-3,
                 max_depth: float = 50.0):
        self.root = root
        self.min_depth, self.max_depth = min_depth, max_depth
        with open(os.path.join(root, "imagelist.txt")) as f:
            self.names = f.read().split()

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int) -> DepthSample:
        b = self.names[idx]
        img = _imread(os.path.join(self.root, "rgb", b + ".png"))
        with Image.open(os.path.join(self.root, "depth", b + ".png")) as dm:
            depth = np.asarray(dm, np.float32) * 50.0 / 65535.0
        with Image.open(os.path.join(self.root, "mask_invalid",
                                     b + ".png")) as m:
            valid = np.asarray(m, np.float32)
        with Image.open(os.path.join(self.root, "mask_transp",
                                     b + ".png")) as m:
            transp = np.asarray(m, np.float32)
        depth = np.where((valid * transp) > 0, depth, -1.0)
        return DepthSample(img, depth,
                           _mask_of(depth, self.min_depth, self.max_depth))


class SunRGBDDataset:
    """SUN RGB-D eval layout (`sun_rgbd_loader.py:80-100`):
    rgb/rgb/*.jpg paired with gt/gt/*.png (uint16 mm); depth > 8 m -> -1."""

    def __init__(self, root: str, min_depth: float = 1e-3,
                 max_depth: float = 8.0):
        self.min_depth, self.max_depth = min_depth, max_depth
        img_dir = os.path.join(root, "rgb", "rgb")
        self.image_files = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir))
        self.depth_files = [
            f.replace(os.path.join("rgb", "rgb"), os.path.join("gt", "gt"))
             .rsplit(".", 1)[0] + ".png" for f in self.image_files]

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx: int) -> DepthSample:
        img = _imread(self.image_files[idx])
        with Image.open(self.depth_files[idx]) as dm:
            depth = np.asarray(dm, np.float32) / 1000.0
        depth = np.where(depth > 8.0, -1.0, depth)
        return DepthSample(img, depth,
                           _mask_of(depth, self.min_depth, self.max_depth))


class DimlIndoorDataset:
    """DIML indoor test layout (`diml_indoor_test.py:83-110`):
    LR/<scene>/color/*_c.png paired with depth_filled/*_depth_filled.png
    (uint16 mm)."""

    def __init__(self, root: str, min_depth: float = 1e-3,
                 max_depth: float = 10.0):
        self.min_depth, self.max_depth = min_depth, max_depth
        self.image_files = []
        lr = os.path.join(root, "LR")
        for scene in sorted(os.listdir(lr)) if os.path.isdir(lr) else []:
            cdir = os.path.join(lr, scene, "color")
            if os.path.isdir(cdir):
                self.image_files += sorted(
                    os.path.join(cdir, f) for f in os.listdir(cdir)
                    if f.endswith(".png"))
        self.depth_files = [
            f.replace("color", "depth_filled")
             .replace("_c.png", "_depth_filled.png")
            for f in self.image_files]

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx: int) -> DepthSample:
        img = _imread(self.image_files[idx])
        with Image.open(self.depth_files[idx]) as dm:
            depth = np.asarray(dm, np.float32) / 1000.0
        return DepthSample(img, depth,
                           _mask_of(depth, self.min_depth, self.max_depth))


class DimlOutdoorDataset:
    """DIML outdoor test layout (`diml_outdoor_test.py:80-105`):
    <set>/outleft/*.png paired with <set>/depthmap/*.png (uint16 mm)."""

    def __init__(self, root: str, min_depth: float = 2.0,
                 max_depth: float = 80.0):
        self.min_depth, self.max_depth = min_depth, max_depth
        self.image_files = []
        for sub in sorted(os.listdir(root)) if os.path.isdir(root) else []:
            odir = os.path.join(root, sub, "outleft")
            if os.path.isdir(odir):
                self.image_files += sorted(
                    os.path.join(odir, f) for f in os.listdir(odir)
                    if f.endswith(".png"))
        self.depth_files = [f.replace("outleft", "depthmap")
                            for f in self.image_files]

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx: int) -> DepthSample:
        img = _imread(self.image_files[idx])
        with Image.open(self.depth_files[idx]) as dm:
            depth = np.asarray(dm, np.float32) / 1000.0
        return DepthSample(img, depth,
                           _mask_of(depth, self.min_depth, self.max_depth))


class DiodeDataset:
    """DIODE layout (`diode.py:82-112`): <scene>/<scan>/*.png with
    *_depth.npy (metres) + *_depth_mask.npy binary validity."""

    def __init__(self, root: str, min_depth: float = 1e-3,
                 max_depth: float = 80.0):
        self.min_depth, self.max_depth = min_depth, max_depth
        self.image_files = []
        for scene in sorted(os.listdir(root)) if os.path.isdir(root) else []:
            sdir = os.path.join(root, scene)
            if not os.path.isdir(sdir):
                continue
            for scan in sorted(os.listdir(sdir)):
                d = os.path.join(sdir, scan)
                if os.path.isdir(d):
                    self.image_files += sorted(
                        os.path.join(d, f) for f in os.listdir(d)
                        if f.endswith(".png"))
        self.depth_files = [f[:-4] + "_depth.npy" for f in self.image_files]
        self.mask_files = [f[:-4] + "_depth_mask.npy"
                           for f in self.image_files]

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx: int) -> DepthSample:
        img = _imread(self.image_files[idx])
        depth = np.load(self.depth_files[idx]).astype(np.float32)
        depth = depth.reshape(depth.shape[:2])
        valid = np.load(self.mask_files[idx]).astype(bool)
        valid = valid.reshape(valid.shape[:2])
        mask = valid & _mask_of(depth, self.min_depth, self.max_depth)
        return DepthSample(img, depth, mask)


def hypersim_distance_to_depth(dist: np.ndarray,
                               focal: float = 886.81) -> np.ndarray:
    """Euclidean ray distance -> planar depth (`hypersim.py:36-48`), for the
    actual image size (the reference hardcodes 1024x768)."""
    h, w = dist.shape[:2]
    x = (np.linspace(-0.5 * w + 0.5, 0.5 * w - 0.5, w, dtype=np.float32)
         .reshape(1, w).repeat(h, 0))
    y = (np.linspace(-0.5 * h + 0.5, 0.5 * h - 0.5, h, dtype=np.float32)
         .reshape(h, 1).repeat(w, 1))
    norm = np.sqrt(x * x + y * y + focal * focal)
    return dist.reshape(h, w) / norm * focal


class HypersimDataset:
    """Hypersim test layout (`hypersim.py:98-131`):
    <scene>/images/scene_cam_*_final_preview/*.tonemap.jpg with depth at
    .../_geometry_hdf5/*.depth_meters.hdf5 (ray distance -> planar depth).
    Requires h5py (gated: raises ImportError at iteration if absent)."""

    def __init__(self, root: str, min_depth: float = 1e-3,
                 max_depth: float = 10.0):
        self.min_depth, self.max_depth = min_depth, max_depth
        self.image_files = []
        for scene in sorted(os.listdir(root)) if os.path.isdir(root) else []:
            idir = os.path.join(root, scene, "images")
            if not os.path.isdir(idir):
                continue
            for cam in sorted(os.listdir(idir)):
                if not (cam.startswith("scene_cam_")
                        and cam.endswith("_final_preview")):
                    continue
                d = os.path.join(idir, cam)
                self.image_files += sorted(
                    os.path.join(d, f) for f in os.listdir(d)
                    if f.endswith(".tonemap.jpg"))
        self.depth_files = [
            f.replace("_final_preview", "_geometry_hdf5")
             .replace(".tonemap.jpg", ".depth_meters.hdf5")
            for f in self.image_files]

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx: int) -> DepthSample:
        import h5py  # noqa: PLC0415 — optional dependency
        img = _imread(self.image_files[idx])
        with h5py.File(self.depth_files[idx], "r") as fd:
            dist = np.array(fd["dataset"], np.float32)
        depth = hypersim_distance_to_depth(dist)
        return DepthSample(img, depth,
                           _mask_of(depth, self.min_depth, self.max_depth))


class VKitti2Dataset:
    """Virtual KITTI 2 layout (`vkitti2.py:83-160`):
    rgb/<scene>/<variant>/frames/rgb/Camera_0/rgb_*.jpg with depth PNGs
    (uint16 cm) under depth/.../depth_*.png; kb_crop applied; depth > 80 m
    -> -1. A deterministic 92/8 per-scene train/test split is written to
    train.txt/test.txt on first walk (the reference shuffles randomly; here
    the sorted order is split deterministically so runs agree)."""

    def __init__(self, root: str, split: str = "test",
                 min_depth: float = 1e-3, max_depth: float = 80.0,
                 do_kb_crop: bool = True):
        self.min_depth, self.max_depth = min_depth, max_depth
        self.do_kb_crop = do_kb_crop
        files = []
        rgb_root = os.path.join(root, "rgb")
        for dirpath, _, fnames in sorted(os.walk(rgb_root)):
            if (os.path.basename(dirpath) == "Camera_0"
                    and f"frames{os.sep}rgb" in dirpath):
                files += sorted(os.path.join(dirpath, f) for f in fnames
                                if f.startswith("rgb_") and
                                f.endswith(".jpg"))
        train_txt = os.path.join(root, "train.txt")
        test_txt = os.path.join(root, "test.txt")
        if not os.path.exists(train_txt):
            by_scene = {}
            for f in files:
                scene = f[len(rgb_root):].lstrip(os.sep).split(os.sep)[0]
                by_scene.setdefault(scene, []).append(f)
            train, test = [], []
            for scene in sorted(by_scene):
                # Fixed-seed per-scene shuffle before the 92/8 split — the
                # reference protocol splits randomly per scene; a sorted
                # (temporally contiguous) tail would correlate test frames
                # with the train-set boundary.
                import zlib  # noqa: PLC0415
                sf = sorted(by_scene[scene])
                seed = zlib.crc32(scene.encode()) % (2 ** 31)
                np.random.RandomState(seed).shuffle(sf)
                k = int(len(sf) * 0.92)
                train += sf[:k]
                test += sf[k:]
            with open(train_txt, "w") as f:
                f.write("\n".join(train))
            with open(test_txt, "w") as f:
                f.write("\n".join(test))
        with open(train_txt if split == "train" else test_txt) as f:
            self.image_files = [l for l in f.read().splitlines() if l]
        self.depth_files = [
            f.replace(f"{os.sep}rgb{os.sep}", f"{os.sep}depth{os.sep}")
             .replace("rgb_", "depth_").replace(".jpg", ".png")
            for f in self.image_files]

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx: int) -> DepthSample:
        img = _imread(self.image_files[idx])
        with Image.open(self.depth_files[idx]) as dm:
            depth = np.asarray(dm, np.float32) / 100.0  # cm -> m
        if self.do_kb_crop:
            img, depth = kb_crop(img), kb_crop(depth)
        depth = np.where(depth > 80.0, -1.0, depth)
        return DepthSample(img, depth,
                           _mask_of(depth, self.min_depth, self.max_depth))


class DdadDataset:
    """DDAD eval layout (`ddad.py:82-110`): flat dir of *_rgb.png paired
    with *_depth.npy metric depth arrays."""

    def __init__(self, root: str, min_depth: float = 1e-3,
                 max_depth: float = 80.0):
        self.min_depth, self.max_depth = min_depth, max_depth
        self.image_files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.endswith("_rgb.png"))
        self.depth_files = [f.replace("_rgb.png", "_depth.npy")
                            for f in self.image_files]

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx: int) -> DepthSample:
        img = _imread(self.image_files[idx])
        depth = np.load(self.depth_files[idx]).astype(np.float32)
        depth = depth.reshape(depth.shape[:2])
        return DepthSample(img, depth,
                           _mask_of(depth, self.min_depth, self.max_depth))


_EVAL_DATASETS = {
    "ibims": IbimsDataset,
    "sunrgbd": SunRGBDDataset,
    "diml_indoor": DimlIndoorDataset,
    "diml_outdoor": DimlOutdoorDataset,
    "diode_indoor": DiodeDataset,
    "diode_outdoor": DiodeDataset,
    "hypersim": HypersimDataset,
    "vkitti2": VKitti2Dataset,
    "ddad": DdadDataset,
}


def make_eval_dataset(name: str, root: str, **kwargs):
    """Per-dataset eval loader multiplexer (`data_mono.py:70-127`): returns
    the layout walker for a named benchmark, with DATASET_PRESETS depth
    bounds applied. KITTI/NYU use their train-layout walkers."""
    if name == "kitti":
        return KittiDepthDataset(kwargs.pop("data_path", root),
                                 kwargs.pop("gt_path", root), **kwargs)
    if name == "nyu":
        return NyuDepthDataset(root, **kwargs)
    cls = _EVAL_DATASETS[name]
    preset = DATASET_PRESETS.get(name, {})
    lo = kwargs.pop("min_depth", preset.get("min_depth_eval", 1e-3))
    hi = kwargs.pop("max_depth", preset.get("max_depth_eval", 80.0))
    return cls(root, min_depth=lo, max_depth=hi, **kwargs)
