"""Train a scene (counterpart of the repo's root ``train.py``).

    python -m priordepth_gaussiansplatting_torch.train -s <scene> [-m <model>]
        [--eval] [--iterations N] [--test_iterations ...]
        [--save_iterations ...] [--checkpoint_iterations ...]
        [--start_checkpoint <model>/chkpnt<it>.pkl] [--data_device cpu]
        [--n_data D] [--n_gauss G] [--tile_shard]

The same flags and artifacts as ``train.py``: ``<model>/cfg_args``,
``events.jsonl``, ``point_cloud/iteration_<it>/point_cloud.ply`` with
``exposure.json``, and ``chkpnt<it>.pkl``. It runs on the card, or on the
CPU with ``--data_device cpu``.

With ``--n_data D --n_gauss G`` above one rank it trains on a D x G grid
of ranks (``parallel/``): D cameras per step, the store sharded over G,
and with ``--tile_shard`` the compositor's tiles split into bands over the
G ranks. Under ``torchrun`` (the environment names the process group:
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) each process joins it and takes
card ``LOCAL_RANK``; otherwise the CLI starts D x G ranks itself, one per
card over NCCL (gloo with ``--data_device cpu``). A world of another size,
or more ranks than the machine has cards, is refused. Rank 0 alone writes
the artifacts and prints.

The thesis events run at ``--noise_injection_iter`` (six floaters
planted) and ``--floating_prune_iter`` (the depth-prior prune loop, which
needs the priors of ``-d <depths>``), 0 turning either off, on one rank or
on a grid. Unless ``--disable_viewer`` is given, the SIBR network viewer
(``viewer/network_gui.py``) listens on ``--ip``/``--port`` (0: a free
port, printed) and is polled after every iteration; a port that cannot be
bound is reported and training goes on. On a grid rank 0 alone binds it,
and each iteration broadcasts one int to the other ranks (go on, join a
render's gather of the store, or wait while the GUI holds training). The
last line is the run's summary as JSON after ``Training complete: ``,
with its skipped updates, the kernel launches of its steps (those of the
evaluations, the events and the viewer's renders left out), by kernel,
the events, and with the viewer on its ``viewer`` counts (renders,
overflowed views, their launches, dropped connections).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import uuid
from argparse import ArgumentParser

import torch
import torch.distributed as dist

from ..data.dataset import Scene
from ..device import resolve_device
from ..parallel import mesh as pmesh
from ..utils.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                            add_dataclass_args, extract_dataclass,
                            torch_device_name)
from ..utils.logging import safe_state
from ..viewer import network_gui
from .trainer import Trainer

# Ranks the CLI starts itself run for as long as training takes.
SPAWN_TIMEOUT = None
# What names a process group that the CLI joins instead of starting one.
GROUP_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


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
                   help="camera data-parallel ranks (one camera each per "
                        "step)")
    p.add_argument("--n_gauss", type=int, default=1,
                   help="Gaussian-shard ranks (the store split over them)")
    p.add_argument("--tile_shard", action="store_true",
                   help="also split the compositor's tiles into bands over "
                        "the Gaussian-shard ranks")
    p.add_argument("--init_capacity", type=int, default=None,
                   help="pre-size the Gaussian store")
    p.add_argument("--pin_pair_capacity", type=int, default=None,
                   help="fix the pair capacity (no adaptive ladder)")
    return p


def build_trainer(args, device=None, mesh=None) -> Trainer:
    """The scene and the trainer of a parsed command line, seeded; on a
    mesh, this rank's (only rank 0 writes the scene's files)."""
    model_cfg = extract_dataclass(ModelConfig, args)
    if device is None:
        device = resolve_device(torch_device_name(model_cfg.data_device))
    safe_state(seed=args.seed)
    writer = mesh is None or mesh.rank == 0
    scene = Scene(model_cfg.source_path,
                  model_cfg.model_path if writer else "",
                  images=model_cfg.images, depths=model_cfg.depths,
                  eval_split=model_cfg.eval, resolution=model_cfg.resolution,
                  white_background=model_cfg.white_background,
                  train_test_exp=model_cfg.train_test_exp, seed=args.seed,
                  device=device)
    return Trainer(model_cfg, extract_dataclass(OptimizationConfig, args),
                   extract_dataclass(PipelineConfig, args), scene,
                   seed=args.seed, quiet=args.quiet,
                   init_capacity=args.init_capacity,
                   pin_pair_capacity=args.pin_pair_capacity, device=device,
                   mesh=mesh, tile_shard=args.tile_shard)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.n_data < 1 or args.n_gauss < 1:
        raise ValueError(f"--n_data {args.n_data} and --n_gauss "
                         f"{args.n_gauss} must be at least 1")
    if not args.model_path:
        args.model_path = f"./output/{str(uuid.uuid4())[:10]}"
    device = resolve_device(torch_device_name(args.data_device))
    world = args.n_data * args.n_gauss
    if world == 1:
        return train(args, device)
    if any(v in os.environ for v in GROUP_ENV):
        return join_group(args, world, device)
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise ValueError(f"--n_data {args.n_data} x --n_gauss "
                         f"{args.n_gauss} needs {world} cards, one per "
                         f"rank; this machine has {torch.cuda.device_count()}")
    # spawn pickles the ranks' function by its import path. Under ``python
    # -m`` this file runs as __main__, which a spawned process does not
    # import, so the function is taken from the module's importable name.
    from . import __main__ as importable  # noqa: PLC0415
    with tempfile.TemporaryDirectory() as tmp:
        results = pmesh.spawn(world, importable.spawned_rank, args,
                              backend=pmesh.backend_for(device),
                              store_dir=tmp, timeout=SPAWN_TIMEOUT)
    return results[0]


def join_group(args, world: int, device: torch.device) -> dict:
    """Join the process group that the environment names (``torchrun``),
    on card ``LOCAL_RANK``, and train this rank."""
    env_world = int(os.environ.get("WORLD_SIZE", -1))
    if env_world != world:
        raise ValueError(f"the environment's WORLD_SIZE {env_world} is not "
                         f"--n_data {args.n_data} x --n_gauss "
                         f"{args.n_gauss} = {world}")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        if local >= torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK {local} names no card: this "
                             f"machine has {torch.cuda.device_count()}")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    pmesh.initialize_multihost(device=device)
    try:
        return train(args, device, mesh_of(args, device))
    finally:
        dist.destroy_process_group()


def spawned_rank(rank: int, world: int, args) -> dict:
    """One rank that the CLI started (``parallel/mesh.py::spawn`` has
    joined the group and, over NCCL, picked card `rank`)."""
    device = resolve_device(torch_device_name(args.data_device))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return train(args, device, mesh_of(args, device))


def mesh_of(args, device: torch.device) -> pmesh.Mesh:
    mesh = pmesh.Mesh(args.n_data, args.n_gauss, device=device)
    if mesh.rank == 0:
        print(f"Multi-chip mesh: data={args.n_data} gauss={args.n_gauss}"
              f"{' tile_shard' if args.tile_shard else ''} over "
              f"{dist.get_world_size()} devices ({mesh.backend})",
              flush=True)
    return mesh


def train(args, device: torch.device, mesh=None) -> dict:
    """Train one rank (or the only one) and print its summary on rank
    0."""
    writer = mesh is None or mesh.rank == 0
    if writer:
        print(f"Output folder: {args.model_path} (device {device})")
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    trainer = build_trainer(args, device, mesh)
    if args.start_checkpoint:
        trainer.restore(args.start_checkpoint)
    gui, viewer_on = open_viewer(args, device, mesh)
    hooks = []
    if args.debug_from >= 0:
        def debug_from(tr, it, metrics):
            if it == max(args.debug_from, 1):
                torch.autograd.set_detect_anomaly(True)
        hooks.append(debug_from)
    if viewer_on:
        hooks.append(viewer_hook(gui, mesh))

    def on_iteration(tr, it, metrics):
        for hook in hooks:
            hook(tr, it, metrics)

    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    try:
        with prof:
            result = trainer.train(
                iterations=trainer.opt_cfg.iterations,
                test_iterations=set(args.test_iterations),
                save_iterations=set(args.save_iterations),
                checkpoint_iterations=set(args.checkpoint_iterations),
                on_iteration=on_iteration if hooks else None)
    finally:
        if gui is not None:
            gui.close()
    if gui is not None:
        result["viewer"] = dict(gui.stats, port=gui.port)
    trainer.logger.close()
    if writer:
        if args.profile:
            trace_dir = os.path.join(args.model_path, "trace")
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        print(f"\nTraining complete: {json.dumps(result)}", flush=True)
    return result


def open_viewer(args, device: torch.device, mesh=None):
    """(rank 0's NetworkGUI or None, whether the viewer is on). Without
    ``--disable_viewer`` rank 0 binds ``--ip``/``--port``; a bind that fails
    is reported and the run goes on without it (``train.py:100-105``). On
    a grid rank 0 broadcasts whether it is on."""
    if args.disable_viewer:
        return None, False
    gui = None
    if mesh is None or mesh.rank == 0:
        try:
            gui = network_gui.NetworkGUI(args.ip, args.port, device=device)
            print(f"network viewer on {args.ip}:{gui.port}", flush=True)
        except OSError as e:
            print(f"network GUI disabled: {e}", flush=True)
    on = gui is not None
    if mesh is not None:
        on = bool(network_gui.broadcast_code(int(on), mesh.device))
    return gui, on


def viewer_hook(gui, mesh=None):
    """The trainer's per-iteration hook that polls the viewer, with
    ``training_done`` from the iteration (``train.py:107-116``). Renders
    see the whole store (on a grid every rank joins its gather); on a
    grid rank 0 ends each poll by broadcasting IDLE and the other ranks
    follow its codes."""
    def poll(tr, it, metrics):
        done = it >= tr.opt_cfg.iterations
        if gui is None:
            network_gui.follow(mesh.device, tr.gathered)
            return
        signal = (None if mesh is None else
                  lambda code: network_gui.broadcast_code(code, mesh.device))
        gui.poll(lambda: tr.gathered()[0], tr.bg, training_done=done,
                 source_path=tr.model_cfg.source_path, signal=signal)
        if mesh is not None:
            network_gui.broadcast_code(network_gui.IDLE, mesh.device)
    return poll


if __name__ == "__main__":
    main(sys.argv[1:])
