"""Depth-stack training run of the port (counterpart of the repo's
``tools/depth_train_proof.py``, with its arguments and JSON fields).

Raycasts an RGB-D set from the synthetic proof scene
(``make_synthetic_scene.py``, true metric depth per pixel), trains
``DepthModel`` with the SILog+GradL1 recipe (``depth/trainer.py``, AdamW
with OneCycle) on the card, and scores the held-out views with the
reference's depth metrics (a1/abs_rel/rmse, ``zoedepth/utils/misc.py:
159-246``). Writes ``DEPTH_RUN_<tag>.{json,md}`` under ``--out_dir``.

    python -m priordepth_gaussiansplatting_torch.depth_train_proof \\
        [steps] [size] [batch] --out_dir DIR [--cpu]
    python -m priordepth_gaussiansplatting_torch.depth_train_proof \\
        400 256 8 --ranks 4 --out_dir DIR        # four ranks it starts
    torchrun --nproc_per_node 4 -m \\
        priordepth_gaussiansplatting_torch.depth_train_proof 400 256 8 \\
        --out_dir DIR                            # a torchrun group

Every rank draws the same ``RandomState(0)`` batches of `batch` views;
rank r of N trains rows [r·batch/N, (r+1)·batch/N) of each, the share
that JAX's ``P("data")`` sharding gives device r. Rank 0 evaluates and
writes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .device import resolve_device
from .parallel import mesh as pmesh

N_TRAIN, N_TEST = 40, 8
MAX_DEPTH = 8.0
SEED = 0  # of the torch.Generator that draws the model's weights
GROUP_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def scene_tool():
    """The port's synthetic-scene generator (its ``camera_pose`` and
    ``render_view``)."""
    from . import make_synthetic_scene
    return make_synthetic_scene


def make_rgbd(n_views: int, size: int):
    """Raycast RGB (n, size, size, 3) and metric depth (n, size, size),
    inf for sky, from the synthetic proof scene."""
    scn = scene_tool()
    imgs, depths = [], []
    for i in range(n_views):
        R, t = scn.camera_pose(i, n_views)
        color, tbest, _ = scn.render_view(R, t, size, 0.82 * size)
        imgs.append(color.astype(np.float32))
        depths.append(tbest.astype(np.float32))
    return np.stack(imgs), np.stack(depths)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=400)
    ap.add_argument("size", nargs="?", type=int, default=128)
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--embed_dim", type=int, default=192)
    ap.add_argument("--encoder_depth", type=int, default=6)
    ap.add_argument("--n_bins", type=int, default=32)
    ap.add_argument("--bin_centers_type", default="normed",
                    help="normed|softplus (reference knob)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tag", default="r04")
    ap.add_argument("--ranks", type=int, default=1,
                    help="start this many ranks (one card each)")
    ap.add_argument("--out_dir", required=True,
                    help="where DEPTH_RUN_<tag>.{json,md} and the logs go")
    return ap.parse_args(argv)


def run(args, device: torch.device, rank: int = 0, world: int = 1) -> dict:
    """Train and evaluate on this rank. Returns the JSON payload (on every
    rank; numbers unrounded) with ``trainer``, the model's ``config``, the
    held-out ``test`` arrays (images, depths, masks) and their clipped
    prediction ``pred`` (rank 0; None elsewhere) beside it."""
    from .depth import config as dcfg
    from .depth.metrics import compute_metrics
    from .depth.trainer import DepthTrainer, DepthTrainerConfig

    steps, size, batch = args.steps, args.size, args.batch
    if batch % world:
        raise ValueError(f"batch {batch} does not split over {world} ranks")
    imgs, depths = make_rgbd(N_TRAIN + N_TEST, size)
    masks = np.isfinite(depths) & (depths > 0.05) & (depths < MAX_DEPTH)
    depths = np.where(masks, depths, 1.0)
    tr_m, te_m = masks[:N_TRAIN], masks[N_TRAIN:]
    if rank == 0:
        tr_d = depths[:N_TRAIN]
        print(f"dataset: {N_TRAIN}+{N_TEST} views @{size}px, depth "
              f"p5/p95 = {np.percentile(tr_d[tr_m], 5):.2f}/"
              f"{np.percentile(tr_d[tr_m], 95):.2f} m", flush=True)
    # The training set lives on the device; a step indexes it there.
    tr_img = torch.from_numpy(imgs[:N_TRAIN]).to(device)
    tr_d = torch.from_numpy(depths[:N_TRAIN]).to(device)
    tr_m = torch.from_numpy(tr_m).to(device)

    # normed bin centers (a reference bin_centers_type) converge within a
    # few hundred steps; the softplus default starts all centers ≈0.7 m
    # and is tuned for multi-epoch schedules.
    cfg = dcfg.get_config("depth", "train", "nyu",
                          embed_dim=args.embed_dim,
                          encoder_depth=args.encoder_depth,
                          n_bins=args.n_bins, max_depth=MAX_DEPTH,
                          bin_centers_type=args.bin_centers_type)
    model = dcfg.build_model(
        cfg, generator=torch.Generator().manual_seed(SEED),
        device=device)
    tcfg = DepthTrainerConfig(steps_per_epoch=steps, epochs=1, lr=args.lr,
                              max_depth=MAX_DEPTH,
                              log_dir=os.path.join(args.out_dir,
                                                   "depth_logs"))
    trainer = DepthTrainer(model, tcfg, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    if rank == 0:
        print(f"model: {n_params / 1e6:.1f}M params", flush=True)

    # Every step's draw up front, in RandomState(0)'s order, copied to the
    # device once: a copy a step from pageable memory would wait for the
    # card.
    rng = np.random.RandomState(0)
    share = slice(rank * batch // world, (rank + 1) * batch // world)
    draws = torch.from_numpy(np.stack([
        rng.choice(N_TRAIN, batch, replace=False)[share]
        for _ in range(steps)])).to(device)
    curve, losses, step_s = [], [], []
    t0 = time.time()
    for s in range(steps):
        ts = time.perf_counter()
        idx = draws[s]
        loss = trainer.train_step(tr_img[idx], tr_d[idx], tr_m[idx])
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if s % 10 == 0 or s == steps - 1:
            curve.append([s, loss])
            if s % 50 == 0 and rank == 0:
                print(f"[{s}/{steps}] silog+grad loss {loss:.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
    wall = time.time() - t0

    out = dict(trainer=trainer, config=cfg, pred=None,
               test=(imgs[N_TRAIN:], depths[N_TRAIN:], te_m))
    m = {}
    if rank == 0:
        # Held-out eval (hard metric depth, garg/eigen-free full mask).
        with torch.inference_mode():
            x = torch.from_numpy(imgs[N_TRAIN:]).to(device)
            pred = model(x.permute(0, 3, 1, 2))["metric_depth"]
        pred = np.clip(pred.cpu().numpy(), tcfg.min_depth, MAX_DEPTH)
        m = compute_metrics(depths[N_TRAIN:][te_m], pred[te_m], crop=None)
        m = {k: float(v) for k, v in m.items()}
        print("eval:", m, flush=True)
        # structured experiment sinks (the reference's wandb role,
        # base_trainer.py:151-199): metric dict + colorized depth triplet
        trainer.log_eval(m)
        trainer.log_depth_images(imgs[N_TRAIN:N_TRAIN + 1],
                                 depths[N_TRAIN:N_TRAIN + 1], pred[:1])
        out["pred"] = pred
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    out["payload"] = {
        "steps": steps, "size": size, "batch": batch,
        "embed_dim": args.embed_dim, "encoder_depth": args.encoder_depth,
        "n_bins": args.n_bins, "bin_centers_type": args.bin_centers_type,
        "wall_s": wall, "steps_per_s": steps / wall,
        "n_params": n_params, "loss_curve": curve, "eval": m,
        "device": device_name, "ranks": world,
        "ms_per_step": 1e3 * float(np.median(step_s[1:] or step_s)),
        "losses": losses}
    return out


def write_report(args, payload: dict) -> None:
    """DEPTH_RUN_<tag>.json and .md under ``--out_dir``."""
    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.join(args.out_dir, f"DEPTH_RUN_{args.tag}")
    with open(base + ".json", "w") as f:
        json.dump(payload, f, indent=1)
    curve, m = payload["loss_curve"], payload["eval"]
    wall, steps = payload["wall_s"], payload["steps"]
    lines = [
        f"# Depth-stack training run — {args.tag} ({payload['device']}, "
        f"{payload['ranks']} rank(s))",
        "",
        f"`DepthModel` ({payload['n_params'] / 1e6:.1f}M params: "
        f"ViT-{args.embed_dim} encoder ×{args.encoder_depth}, DPT decoder, "
        f"{args.n_bins}-bin metric head) trained with the SILog+GradL1 "
        "recipe (`depth/trainer.py`, reference `zoedepth_trainer.py:39-104`)"
        f" on a raycast synthetic RGB-D set ({N_TRAIN} train / {N_TEST} test"
        f" views @{args.size}²).",
        "",
        f"* {steps} steps, batch {args.batch}: **{wall:.0f} s** "
        f"({payload['steps_per_s']:.2f} steps/s, median "
        f"{payload['ms_per_step']:.2f} ms a step) on `{payload['device']}`",
        f"* SILog+GradL1: **{curve[0][1]:.3f} → {curve[-1][1]:.3f}**",
        f"* held-out metrics: a1 **{m.get('a1', 0):.4f}**, abs_rel "
        f"**{m.get('abs_rel', 0):.4f}**, rmse **{m.get('rmse', 0):.4f}** "
        "(reference metric names, `zoedepth/utils/misc.py:159-246`)",
        "",
        "| step | loss |", "|---|---|",
    ]
    lines += [f"| {s} | {v:.4f} |"
              for s, v in curve[:: max(1, len(curve) // 15)]]
    with open(base + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")


def train_rank(args, device: torch.device) -> dict:
    """Run this rank (of the group, if one is initialised) and, on rank 0,
    write the report and print its summary line. Returns the payload."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    payload = run(args, device, rank, world)["payload"]
    if rank == 0:
        write_report(args, payload)
        print(json.dumps({k: v for k, v in payload.items()
                          if k not in ("loss_curve", "losses")}), flush=True)
    return payload


def spawned_rank(rank: int, world: int, args) -> dict:
    """One rank that ``--ranks`` started (``parallel/mesh.py::spawn`` has
    joined the group and, over NCCL, picked card `rank`)."""
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return train_rank(args, device)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if any(v in os.environ for v in GROUP_ENV):
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        pmesh.initialize_multihost(device=device)
        try:
            return train_rank(args, device)
        finally:
            dist.destroy_process_group()
    if args.ranks == 1:
        return train_rank(args, device)
    if device.type == "cuda" and torch.cuda.device_count() < args.ranks:
        raise ValueError(f"--ranks {args.ranks} needs {args.ranks} cards; "
                         f"this machine has {torch.cuda.device_count()}")
    # spawn pickles the ranks' function by its import path; under ``python
    # -m`` this file runs as __main__, which a spawned process does not
    # import.
    from . import depth_train_proof as importable  # noqa: PLC0415
    with tempfile.TemporaryDirectory() as tmp:
        return pmesh.spawn(args.ranks, importable.spawned_rank, args,
                           backend=pmesh.backend_for(device),
                           store_dir=tmp, timeout=None)[0]


if __name__ == "__main__":
    main(sys.argv[1:])
