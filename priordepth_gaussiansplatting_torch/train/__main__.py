"""Train a scene (counterpart of the repo's root ``train.py``).

    python -m priordepth_gaussiansplatting_torch.train -s <scene> [-m <model>]
        [--eval] [--iterations N] [--test_iterations ...]
        [--save_iterations ...] [--checkpoint_iterations ...]
        [--start_checkpoint <model>/chkpnt<it>.pkl] [--data_device cpu]

The same flags and artifacts as ``train.py``: ``<model>/cfg_args``,
``events.jsonl``, ``point_cloud/iteration_<it>/point_cloud.ply`` with
``exposure.json``, and ``chkpnt<it>.pkl``. It runs on the card, or on the
CPU with ``--data_device cpu``. Not ported yet, so refused: the multi-rank
flags ``--n_data``/``--n_gauss`` above 1 and ``--tile_shard`` (ROADMAP
queue 1, item 2), and runs that reach an enabled thesis event (item 4: pass
``--noise_injection_iter 0 --floating_prune_iter 0``). The network viewer
(item 6) is not ported: without ``--disable_viewer`` the CLI says so once
and trains. The last line is the run's summary as JSON after
``Training complete: ``, with its skipped updates and the kernel launches
of its steps (those of the evaluations left out), by kernel.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import uuid
from argparse import ArgumentParser

import torch

from ..data.dataset import Scene
from ..device import resolve_device
from ..utils.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                            add_dataclass_args, extract_dataclass,
                            torch_device_name)
from ..utils.logging import safe_state
from .trainer import Trainer


def parser() -> ArgumentParser:
    p = ArgumentParser(description="Train a 3D Gaussian Splatting model")
    add_dataclass_args(p, ModelConfig())
    add_dataclass_args(p, OptimizationConfig())
    add_dataclass_args(p, PipelineConfig())
    p.add_argument("--ip", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[7000, 30000])
    p.add_argument("--save_iterations", nargs="+", type=int,
                   default=[7000, 30000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=[])
    p.add_argument("--start_checkpoint", type=str, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--disable_viewer", action="store_true")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="torch.autograd.set_detect_anomaly for the run")
    p.add_argument("--debug_from", type=int, default=-1,
                   help="turn anomaly detection on from this iteration")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace to <model>/trace")
    p.add_argument("--n_data", type=int, default=1,
                   help="data ranks (not ported yet: must be 1)")
    p.add_argument("--n_gauss", type=int, default=1,
                   help="Gaussian-shard ranks (not ported yet: must be 1)")
    p.add_argument("--tile_shard", action="store_true",
                   help="tile bands over the gauss ranks (not ported yet)")
    p.add_argument("--init_capacity", type=int, default=None,
                   help="pre-size the Gaussian store")
    p.add_argument("--pin_pair_capacity", type=int, default=None,
                   help="fix the pair capacity (no adaptive ladder)")
    return p


def build_trainer(args) -> Trainer:
    """The scene and the trainer of a parsed command line, seeded."""
    model_cfg = extract_dataclass(ModelConfig, args)
    device = resolve_device(torch_device_name(model_cfg.data_device))
    safe_state(seed=args.seed)
    scene = Scene(model_cfg.source_path, model_cfg.model_path,
                  images=model_cfg.images, depths=model_cfg.depths,
                  eval_split=model_cfg.eval, resolution=model_cfg.resolution,
                  white_background=model_cfg.white_background,
                  train_test_exp=model_cfg.train_test_exp, seed=args.seed,
                  device=device)
    return Trainer(model_cfg, extract_dataclass(OptimizationConfig, args),
                   extract_dataclass(PipelineConfig, args), scene,
                   seed=args.seed, quiet=args.quiet,
                   init_capacity=args.init_capacity,
                   pin_pair_capacity=args.pin_pair_capacity, device=device)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.n_data * args.n_gauss > 1 or args.tile_shard:
        raise NotImplementedError(
            "multi-rank training (--n_data/--n_gauss above 1, --tile_shard) "
            "is not ported yet (ROADMAP queue 1, item 2)")
    if not args.model_path:
        args.model_path = f"./output/{str(uuid.uuid4())[:10]}"
    device = resolve_device(torch_device_name(args.data_device))
    print(f"Output folder: {args.model_path} (device {device})")
    if not args.disable_viewer:
        print("network viewer: not ported yet (ROADMAP queue 1, item 6); "
              "training without it")
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    trainer = build_trainer(args)
    if args.start_checkpoint:
        trainer.restore(args.start_checkpoint)

    def debug_from(tr, it, metrics):
        if it == max(args.debug_from, 1):
            torch.autograd.set_detect_anomaly(True)

    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    with prof:
        result = trainer.train(
            iterations=trainer.opt_cfg.iterations,
            test_iterations=set(args.test_iterations),
            save_iterations=set(args.save_iterations),
            checkpoint_iterations=set(args.checkpoint_iterations),
            on_iteration=debug_from if args.debug_from >= 0 else None)
    if args.profile:
        trace_dir = os.path.join(args.model_path, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    trainer.logger.close()
    print(f"\nTraining complete: {json.dumps(result)}", flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
