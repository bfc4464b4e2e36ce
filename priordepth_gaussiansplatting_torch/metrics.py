"""SSIM, PSNR and LPIPS of rendered views against their ground truth.

    python -m priordepth_gaussiansplatting_torch.metrics -m <model> [...]
        [--device cpu]

The port's counterpart of the root ``metrics.py`` (reference
``metrics.py``): for each ``<model>/test/<method>/{renders,gt}`` it prints
the same lines and writes the same ``<model>/results.json`` and
``per_view.json``, LPIPS only when ``PDGS_LPIPS_WEIGHTS`` names weights
(``eval/metrics.py``). It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from .device import resolve_device
from .eval.metrics import compute_lpips, have_lpips
from .ops.losses import psnr
from .ops.ssim import ssim


def read_images(renders_dir, gt_dir):
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        r = np.asarray(Image.open(os.path.join(renders_dir, fname)),
                       dtype=np.float32)[..., :3] / 255.0
        g = np.asarray(Image.open(os.path.join(gt_dir, fname)),
                       dtype=np.float32)[..., :3] / 255.0
        renders.append(r.transpose(2, 0, 1))
        gts.append(g.transpose(2, 0, 1))
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths, device=None):
    device = resolve_device(device)
    full_dict, per_view_dict = {}, {}
    for scene_dir in model_paths:
        print(f"Scene: {scene_dir}")
        full_dict[scene_dir] = {}
        per_view_dict[scene_dir] = {}
        test_dir = os.path.join(scene_dir, "test")
        for method in sorted(os.listdir(test_dir)):
            print(f"Method: {method}")
            mdir = os.path.join(test_dir, method)
            renders, gts, names = read_images(
                os.path.join(mdir, "renders"), os.path.join(mdir, "gt"))
            use_lpips = have_lpips()
            if not use_lpips:
                print("  WARNING: LPIPS omitted — no VGG16 weights found. "
                      "Export them once with scripts/export_lpips_weights.py"
                      " and set PDGS_LPIPS_WEIGHTS to the file; results.json"
                      " will not contain an LPIPS key until then.",
                      flush=True)
            ssims, psnrs, lpipss = [], [], []
            for r, g in zip(renders, gts):
                rt = torch.as_tensor(r, device=device)
                gt = torch.as_tensor(g, device=device)
                ssims.append(float(ssim(rt, gt)))
                psnrs.append(float(psnr(rt, gt)))
                if use_lpips:
                    lpipss.append(compute_lpips(rt, gt))
            full_dict[scene_dir][method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
            }
            per_view_dict[scene_dir][method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
            }
            # Without weights LPIPS is left out, not written as -1: a -1
            # averaged into a results table reads as data.
            if use_lpips:
                full_dict[scene_dir][method]["LPIPS"] = float(
                    np.mean(lpipss))
                per_view_dict[scene_dir][method]["LPIPS"] = dict(
                    zip(names, lpipss))
            print(f"  SSIM : {np.mean(ssims):.7f}")
            print(f"  PSNR : {np.mean(psnrs):.7f}")
            if use_lpips:
                print(f"  LPIPS: {np.mean(lpipss):.7f}")
            else:
                print("  LPIPS: (skipped — no weights; set "
                      "PDGS_LPIPS_WEIGHTS)")
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict[scene_dir], f, indent=True)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view_dict[scene_dir], f, indent=True)
    return full_dict


def main(argv=None) -> dict:
    parser = ArgumentParser(description="Compute metrics over renders")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
