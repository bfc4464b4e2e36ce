"""Batch-render train/test views of a saved model to PNGs.

    python -m priordepth_gaussiansplatting_torch.render -m <model> [flags]

The port's counterpart of the root ``render.py``: the same flags, the same
``<model>/cfg_args`` merge and the same output,
``<model>/{train,test}/ours_<iter>/{renders,gt}/*.png``. ``--data_device``
picks the device: ``cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch
from PIL import Image

from .data.dataset import Scene
from .device import resolve_device
from .train import step as step_lib
from .train.checkpoint import latest_iteration, load_model_snapshot
from .utils.config import (ModelConfig, PipelineConfig, add_dataclass_args,
                           extract_dataclass, get_combined_args,
                           torch_device_name)


def save_png(path, img_chw: torch.Tensor) -> None:
    arr = (torch.clamp(img_chw, 0, 1) * 255).to(torch.uint8)
    Image.fromarray(arr.permute(1, 2, 0).cpu().numpy()).save(path)


def render_set(model_path, name, iteration, cameras, state, bg, pipe,
               train_test_exp):
    rdir = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gdir = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(rdir, exist_ok=True)
    os.makedirs(gdir, exist_ok=True)
    for idx, cam in enumerate(cameras):
        out = step_lib.eval_image(
            cam, state, bg, antialiasing=pipe.antialiasing,
            use_trained_exp=train_test_exp, backend=pipe.backend)
        if out.get("overflow") is not None and int(out["overflow"]) > 0:
            print(f"WARNING: view {idx} overflowed the pair capacity by "
                  f"{int(out['overflow'])} — rendered image is missing "
                  "splats; re-render with a larger capacity", flush=True)
        img = out["render"]
        gt = cam.image
        if train_test_exp:  # left half was used for exposure training
            img = img[..., img.shape[-1] // 2:]
            gt = gt[..., gt.shape[-1] // 2:] if gt is not None else None
        save_png(os.path.join(rdir, f"{idx:05d}.png"), img)
        if gt is not None:
            save_png(os.path.join(gdir, f"{idx:05d}.png"), gt)


def main(argv=None):
    parser = ArgumentParser(description="Render a trained model")
    add_dataclass_args(parser, ModelConfig())
    add_dataclass_args(parser, PipelineConfig())
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    args = get_combined_args(parser, argv)
    model_cfg = extract_dataclass(ModelConfig, args)
    pipe_cfg = extract_dataclass(PipelineConfig, args)
    device = resolve_device(torch_device_name(model_cfg.data_device))
    print(f"Rendering {model_cfg.model_path} on {device}")

    state = load_model_snapshot(model_cfg.model_path, args.iteration,
                                max_sh_degree=model_cfg.sh_degree,
                                device=device)
    iteration = args.iteration
    if iteration == -1:
        iteration = latest_iteration(model_cfg.model_path)
    scene = Scene(model_cfg.source_path, "", images=model_cfg.images,
                  depths=model_cfg.depths, eval_split=model_cfg.eval,
                  resolution=model_cfg.resolution,
                  white_background=model_cfg.white_background,
                  train_test_exp=model_cfg.train_test_exp, shuffle=False,
                  device=device)
    # Pretrained exposures: align the saved per-image table with the
    # scene's train-image order.
    exp_path = os.path.join(model_cfg.model_path, "exposure.json")
    if model_cfg.train_test_exp and os.path.exists(exp_path):
        with open(exp_path) as f:
            exposures = json.load(f)
        table = np.tile(np.eye(3, 4, dtype=np.float32)[None],
                        (max(len(scene.exposure_ids), 1), 1, 1))
        for name, idx in scene.exposure_ids.items():
            if name in exposures:
                table[idx] = np.asarray(exposures[name], np.float32)
        state = state.replace(params=state.params.replace(
            exposure=torch.as_tensor(table, device=device)))

    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background
                      else [0.0, 0.0, 0.0], device=device)
    if not args.skip_train:
        render_set(model_cfg.model_path, "train", iteration,
                   scene.train_cameras, state, bg, pipe_cfg,
                   model_cfg.train_test_exp)
    if not args.skip_test:
        render_set(model_cfg.model_path, "test", iteration,
                   scene.test_cameras, state, bg, pipe_cfg,
                   model_cfg.train_test_exp)


if __name__ == "__main__":
    main(sys.argv[1:])
