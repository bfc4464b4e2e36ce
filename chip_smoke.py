#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # one card, every phase below
    python3 chip_smoke.py --ranks 4  # only the multi-rank phases, 4 cards
    python3 chip_smoke.py --turns DIR  # only K7 and K1 against DIR's
    python3 chip_smoke.py --phases depth viewer  # device, train_cli, these
    python3 chip_smoke.py --ranks 4 --phases depth_dp  # only that one

Builds the port's CUDA kernels from ``priordepth_gaussiansplatting_torch/
csrc/`` (one nvcc per source, in parallel), then runs, printing one JSON
line per phase:

  1. device: the card, its power limit, the toolkit, the build (with each
     library's registers and spills from ptxas, and the blocks and warps
     per SM of the compositor's, K1's, K7's and K4's entry points from the
     occupancy calculator, K4 at the 128 and 1,024 ids per block of the mid
     and the full scene) and the TF32 switches (both must be off);
  2. mid: each forward kernel against its plain PyTorch version on the same
     inputs (65,536 Gaussians at 512x512, SH degree 3, antialiasing; and a
     dense-overlap scene), then K3 from random cotangents (deterministic,
     its evaluated pairs equal to K2's, against its plain version), and on
     the 65,536-Gaussian scene K2's and K3's times beside their bounds;
  3. full: 1,000,000 Gaussians at 1600x1066 (bench.py's random Gaussians,
     drawn with numpy) rendered through ops.render.render(backend=
     "kernels") for three views, with the launch counts of that run, each
     forward kernel against its plain version at full width, and CUDA-event
     times (``gather``: K5a beside its library call, and walking 1, 2 and
     all 11 rows per pass); then "profile": device time by kernel and host
     time by operator of one render per view, from torch.profiler;
  4. train: the same scene trained for 10 steps of
     train.step.make_train_step over the three views (L1 + D-SSIM +
     depth-L1 against a random inverse-depth prior, Adam, densification
     statistics), with every step's launch counts, gradients and guard
     checked; the backward kernels against their plain versions on view 0's
     own intermediates (K4 also twice, bit for bit), CUDA-event times
     (``gather``: K5b as in full, and on a source that stays in L2; ``k4``:
     K4 beside ``torch.segment_reduce`` and ``index_add_``); fwd+bwd and
     full-step times; then
     "train_profile": the profiler's breakdown of one train step per view;
  5. train_mid: the mid scene's parameter gradients from the kernels
     against those from the plain versions on the same card, K4 on that
     step's own pairs (``k4``, as in train), then 3 steps,
     a densify round (first against the same round on the CPU), an opacity
     reset and 2 more steps;
  6. bands: view 0 of the full scene composited band by band with K6
     (ops.rasterize.composite_bands, forward and backward) in 4 and in 3
     bands, the launch counts of that run; the assembled frame against K2
     and the summed band gradients against K3, bit for bit; two slices of
     8 slots (the busiest tiles; the last tiles and the pad slots) and a
     whole band against the plain version; CUDA-event times per band;
  7. sharded: parallel.integrate.make_sharded_fns in a one-rank NCCL
     process group on the card: 10 steps over the three views of the full
     scene (every step's launches, guard and gradients checked), 3 steps
     against train.step.make_train_step from the same state, then on the
     mid scene a sharded densify round, an opacity reset and a step;
  8. cli: the port's render CLI on a raycast synthetic scene;
  9. bin: K7 (``ops.binning.expand_tiles``) through ``bin_gaussians`` on
     view 0 of the full scene with P = 2^22, the launch counts of that run;
     its slots and histogram against the plain version bit for bit, the
     TileBinning against the plain pipeline's, a rect 256 tiles wide (a
     4096-pixel-wide camera) against a direct enumeration, and a case
     whose blocks' owners reach past K7's window (they search in device
     memory) bit for bit; the blocks that spill on both scenes under K7's
     window and under K1's; K7's time queued and unqueued;
 10. probe: ``python -m priordepth_gaussiansplatting_torch.perf_probe
     1000000 1600 1066`` (stage times; K7 launched once per bin+sort call);
 11. train_cli: ``python -m priordepth_gaussiansplatting_torch.train`` on a
     512x512, 32-view raycast scene for 1,000 iterations with a store of
     2^18 rows, whose default pair capacity (2^20) holds every pair of an
     evaluation view, and the steps' pair capacity pinned there too (the
     steps launching K1, K5a, K2, K3, K5b and K4 once each per iteration
     over the run, none skipped, no evaluation view overflowing, held-out
     PSNR higher at 1,000 than at 500), a resume from its iteration-500
     checkpoint, and the render CLI on its snapshot;
 12. mesh_train: ``train.trainer.Trainer(mesh=Mesh(1, 1))`` in a one-rank
     NCCL group on train_cli's scene and flags for 1,000 iterations (none
     skipped, held-out PSNR higher at 1,000 than at 500, each step kernel
     once per iteration): its per-iteration losses equal (rel 1e-5) to
     the single-rank trainer's, the two fed the same split draws, and up
     to the first densify round that trainer's equal to the train_cli
     run's logged ones; a resume from its iteration-500 checkpoint for 20
     iterations, and its it/s beside train_cli's;
 13. thesis: train_cli's scene with inverse-depth priors (16-bit PNGs under
     ``depths/``, from the scene generator's own ``camera_pose`` and
     ``render_view``) through the train CLI with ``-d depths`` for 1,000
     iterations, the noise injection at 700 (+6 active rows) and the
     floating-object prune at 900 (its deletions and views printed, each
     view rendered through K1, K5a and K2, none overflowing its pair
     capacity, no update skipped, held-out PSNR logged); then from the
     checkpoint at 899 ``train/prune.py::prune_loop`` with one RandomState
     seed three times: on the card through the kernels, on the card through
     their plain versions, and on the CPU; each run's deletion history is
     printed, and the final active masks must agree except on rows whose
     rendered inverse depth lay within 2e-5 of a threshold (or whose centre
     lay within 1e-4 px of a pixel edge) in a view of either run, which are
     counted; then one prune view at full width (view 0 of the full scene,
     a prior of sky on its left half, nearer than every Gaussian on its
     right, so that about half the rows it judges go): the kernel
     render's mask against the plain render's, counted the same way, and
     the time of render + ``prune_view`` by CUDA events;
 14. metrics: ``python -m priordepth_gaussiansplatting_torch.metrics`` on the
     render CLI's output of train_cli (its held-out views at 1,000) with
     random VGG16 LPIPS weights written from a numpy seed, on the card
     against ``--device cpu`` (PSNR and SSIM within 1e-4, LPIPS rtol 1e-3),
     and its PSNR beside the trainer's report for the same views;
 15. depth: the depth-prior inference path (``depth/``, no kernel of the
     table) with the repo's configuration (embed 384, 6 blocks, 6 heads,
     patch 16, 16 bins) and weights drawn from a seed: the TTA priors of
     train_cli's 32 images (1,024² inputs, 4,096 patches, the positional
     table's limit), ms an image with and without the flip, peak memory;
     one image's depth on the card against the CPU's, the fused attention
     against the plain form, DepthModelNK once (soft and hard, against the
     CPU), and a ViT-L encoder (DepthAnythingV2-L's DINOv2 layout) imported
     from a random state dict written with torch.save, at 518² against the
     CPU, its ms and peak memory;
 16. depth_chain: train_cli's scene with 2D observations of its sparse
     points, priors by that model on the card, ``make_depth_scale`` (a
     non-empty ``depth_params.json``), then the train CLI with ``-d
     depths`` for 300 iterations (finite losses, no skipped update);
 17. chain: the chain CLIs on train_cli's scene, through executable
     stand-ins for ffmpeg, COLMAP, DepthAnythingV2's ``run.py`` and the
     SIBR app (``utils/standins.py``; none of the tools is installed):
     ``python -m priordepth_gaussiansplatting_torch.train_video`` (frames)
     -> ``train_image`` -> ``convert`` (the four COLMAP commands, the
     ``sparse/*`` move into ``sparse/0``) -> ``run.py`` (the repo's depth
     configuration with DEPTH_SEED's weights on the card) ->
     ``make_depth_scale`` -> the train CLI with ``-d depths`` and
     train_cli's flags for 300 iterations (every command in the order of
     the root scripts, finite fitted scales, no skipped update, finite
     losses and held-out PSNR, each step kernel once per iteration on the
     card), then ``SIBR_viewer --with_metrics`` (the render and metrics
     CLIs, a finite PSNR; the app given ``-m <model>``), ``convert`` with a
     COLMAP that exits with 3 (it must exit with 3), and the native COLMAP
     reader (``data/native.py``, its library built here) on a model of a
     Mip-NeRF 360 capture's size (200 images x 10,000 2D points, 200,000
     points with 10-entry tracks) against the Python readers, field by
     field, with both readers' seconds;
 18. viewer: the network viewer in-process over loopback, a client asking
     for a held-out view of train_cli's checkpoint at 512² and view 0 of
     the full scene at 1600x1066 (every image equal to a direct render
     through K1, K5a and K2, within one level of the plain versions',
     launched once each per request, none overflowing; ms a request), then
     the train CLI with the viewer on and a client that holds training for
     three requests and lets it go on (equal images while held, a later
     one after; the renders' launches apart from the steps');
 19. depth_train: the depth trainer (``depth/trainer.py``, no kernel of the
     table): the repo's depth configuration at 128², batch 4, 3 steps from
     seeded weights on raycast views, on the card against the CPU and with
     the plain attention form against the fused one (losses within 1e-4
     relative, parameter changes at the Adam tolerance of
     ``utils/testing.py::adam_agreement``); then ``docs/DEPTH_RUN_r05.md``'s
     recipe through ``depth_train_proof.run`` (ViT-768 x 12, DPT decoder, 64
     normed bins, 256², batch 8, 400 steps, 40 + 8 views): steps/s, ms a
     step, a step's FLOP (``FlopCounterMode``) and its f32 bound, peak
     memory, the losses (finite; the last 20 steps' mean at most half the
     first 20's), held-out a1/abs_rel/rmse, and a checkpoint written and
     reloaded into a model of other weights predicting the same depth;
 20. kernels: one object per kernel (the line before the card's line).
Then the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.

With ``--turns DIR`` it builds the kernels and runs one phase, turns: K7
and K1 of this checkout in turns with those built from another checkout's
``csrc/`` (DIR, e.g. the parent commit unpacked with ``git archive``), on
one card, each checked against its plain version and timed queued.

With ``--ranks N`` it builds the kernels and runs one phase, multi_rank:
N processes, one per card, in an NCCL group (parallel/mesh.py::spawn). On
the full scene each rank runs the sharded step for the grids (1, N) with
tile bands (K6), (1, N), (N, 1) and, for N = 4, (2, 2) with tile bands:
one step against single-rank steps on its own card (the mean over the
batch's views of their gradients, its own rows, gradient tolerance), then
10 steps with every launch count and guard checked, and the time per step
beside the single-rank step's on the same card. Then phase multi_cli: the
train CLI itself, starting its N ranks, on train_cli's scene for 500
iterations over (1, N) with tile bands and, for N = 4, (2, 2) with the
depth priors and both thesis events (at 300 and 400; every rank's active
count the same after each), the same (2, 2) run with the network viewer on
(rank 0 binds it) and a client that holds training for three requests,
its it/s beside the run without the viewer, it/s and held-out PSNR, and a
single-rank checkpoint restored over (1, N), whose shards' active rows
differ by at most one. Then phase depth_dp: the depth trainer over N
cards (NCCL; the repo's configuration at 256², global batch 8, the first
20 steps of the recipe's 400-step schedule): every rank's losses equal,
at every step rank 0's loss and averaged gradients against the whole
global batch on rank 0 alone at the same parameters (loss within 1e-4
relative, gradients at the gradient tolerance), then a one-rank run over
the same batches (its first loss within 1e-4; the drift of the later ones
printed), and steps/s of one rank and of N. ``--ranks N --phases NAME``
runs only the named ones of multi_rank, multi_cli and depth_dp.

With ``--phases NAME ...`` it builds the kernels and runs phase device,
the named ones of train_cli, mesh_train, thesis, metrics, depth,
depth_chain, chain, viewer and depth_train (train_cli first when another
of them uses its scene: all but depth_train do), without the kernels line.

Any failure raises: the script exits non-zero, and it does so before
printing a result when there is no CUDA card or when the port is not
beside it.

Tolerances: K1 (pair expansion) and K5a (pair table) must equal their plain
versions bit for bit; K1's only allowed difference is a pair whose box
minimum lies within one f32 ulp of the cull limit (logf rounding), at most
0.001% of the rect pairs. K2 (compositor) must be within 2e-5 on >= 99.9% of
values and within 5e-3 everywhere: a product rounded differently can move
the T < 1e-4 stop by one pair (the repo's dense-overlap rule). K3 (composite
backward) per-pair rows within 3e-4 max|row| + 2e-3 |ref| on >= 99.9% of
entries (the JAX package's gradient rule; a stop moved by one pair moves
the rest of that pixel's pairs), its evaluated pairs equal to K2's on every
pixel (both walk through one evaluation function), and two launches equal
bit for bit. K5b (sort-back) bit for bit, and the key K4 reads (the
id sort's values) equal to the key gathered through K5b's permutation. K4
(per-Gaussian sum) within 1e-5 max|row| of a float64 sum, and two launches
equal bit for bit. K6 (the band
compositor): the assembled bands equal K2's frame and the summed band
tables K3's bit for bit, each band's table is zero outside its pairs, and
against its plain version K2's and K3's rules. Parameter gradients,
kernels against plain versions, and the sharded step against the
single-rank step: atol 3e-4 max|g|, rtol 2e-3. A densify round on the
card against the same round on the CPU (same split draws): equal counts
and active rows, parameters and moments within 1e-5. K7 (the tile-only
pair expansion) and bin_gaussians: bit for bit against the plain versions
and the direct enumeration. Depth (the depth model, DepthModelNK, the ViT-L
encoder) on the card against the CPU, and the fused attention against the
plain form: max|difference| within 1e-3 x max|depth| (or |feature|).
Viewer images: equal to a direct render through the kernels, within one
level of 255 of the plain versions'.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# The port's entry points are PORT + name (python -m).
PORT = "priordepth_gaussiansplatting_torch."
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor) rate.
CARD_BYTES_PER_S = 3.35e12
CARD_F32_OPS_PER_S = 67e12
# Work per unit, counted from the kernels' sources.
K1_OPS_PER_SLOT = 70      # the cull's f32 operations per pair slot < total
K2_OPS_PER_EVAL = 20      # f32 operations per (pixel, pair), expf as one
# K3 redoes K2's 20 per evaluation, and per evaluation that a kept, live
# pair contributes: rho (7), prefix and suffix (3), g_alpha (5), d_power
# (1), the 10 values (30) and T (1).
K3_OPS_PER_USED = 47
# Launch label -> (id, CUDA source, the TPU kernel it replaces).
TPU = "priordepth_gaussiansplatting_tpu/ops/"
KERNELS = {
    "expand_pairs": ("K1", "expand_pairs", TPU + "binning.py:589"),
    "gather_rows": ("K5a", "gather_rows", TPU + "binning.py:1003"),
    "composite_fwd": ("K2", "composite_fwd", TPU + "rasterize_pallas.py:272"),
    "composite_bwd": ("K3", "composite_bwd", TPU + "rasterize_pallas.py:418"),
    "gather_rows_bwd": ("K5b", "gather_rows", TPU + "binning.py:1051"),
    "segment_reduce": ("K4", "segment_reduce", TPU + "binning.py:429"),
    # K6: _make_composite(num_local_tiles=...) through composite_bands.
    "composite_fwd_bands": ("K6", "composite_fwd",
                            TPU + "rasterize_pallas.py:913"),
    "composite_bwd_bands": ("K6", "composite_bwd",
                            TPU + "rasterize_pallas.py:913"),
    # K7: _expand_kernel_factory through bin_gaussians (call :220).
    "expand_tiles": ("K7", "expand_pairs", TPU + "binning.py:83"),
}
FORWARD = ("expand_pairs", "gather_rows", "composite_fwd")
# The kernels of one train step on the whole frame (single-rank or sharded
# on one rank), each launched once per step.
STEP = ("expand_pairs", "gather_rows", "composite_fwd", "composite_bwd",
        "gather_rows_bwd", "segment_reduce")
BANDS = ("composite_fwd_bands", "composite_bwd_bands")
# ... and of a step whose compositor is split into tile bands (K6).
TILE_STEP = ("expand_pairs", "gather_rows", "gather_rows_bwd",
             "segment_reduce") + BANDS
BAND_COUNTS = (4, 3)
FULL_N, FULL_W, FULL_H = 1_000_000, 1600, 1066
FULL_EYES = [(0.0, 0.0, -2.5), (0.25, -0.15, -2.45), (-0.3, 0.1, -2.4)]
# --ranks: a fourth view, so that four data ranks see four cameras.
MULTI_EYES = FULL_EYES + [(0.15, 0.2, -2.45)]
MID_N, MID_WH = 65_536, 512
TRAIN_STEPS = 10
# bin: the pair capacity of bin_gaussians at full width, and the wide view.
BIN_P = 1 << 22
WIDE_W, WIDE_H, WIDE_N = 4096, 256, 2000
# train_cli: the scene (size, views), the run's iterations, its store and
# its pair capacity (the JAX trainer's ladder skips updates when the pairs
# outgrow its last rung, so the run pins the capacity, as the PROOF_r05
# runs do).
CLI_SCENE = (512, 32)
CLI_ITERS, CLI_CHECK, CLI_RESUME = 1000, 500, 20
CLI_CAPACITY, CLI_PAIRS = 1 << 18, 1 << 20
# --ranks: the train CLI's iterations on train_cli's scene per rank grid,
# and the thesis events of its (2, 2) run.
MULTI_CLI_ITERS = 500
MULTI_INJECT, MULTI_PRUNE = 300, 400
# thesis: the events of train_cli's run with priors (the prune loops start
# from the checkpoint before the prune, with one RandomState seed), the
# render tolerance on inverse depth that excuses a row's prune decision,
# and the distance to a pixel edge within which devices may read another
# pixel; at full width the prior inverse depth of view 0's left half (sky)
# and right half (nearer than every Gaussian), and the scene extent.
THESIS_INJECT, THESIS_PRUNE, THESIS_SEED = 700, 900, 900
INVDEPTH_TOL, EDGE_TOL_PX = 2e-5, 1e-4
FULL_PRIOR, FULL_EXTENT = (0.0, 2.0), 0.5
# metrics: the card's results against the CPU's.
METRICS_ATOL, LPIPS_RTOL = 1e-4, 1e-3
# depth: the repo's depth configuration (depth/config.py: embed 384, 6
# blocks, 6 heads, patch 16, 16 bins) with weights drawn from DEPTH_SEED,
# on train_cli's 512² images (TTA pads them to 1,024²: 4,096 patches, the
# positional table's rows); its depths on the card against the CPU's and
# its fused attention against the plain form, within DEPTH_RTOL x
# max|depth|; a ViT-L-geometry encoder (DepthAnythingV2-L's DINOv2 layout:
# embed 1024, 24 blocks, 16 heads, patch 14, class token, LayerScale,
# final norm; taps after blocks 4, 11, 17 and 23) imported from a random
# state dict, at 518² (37² patches).
DEPTH_SEED, DEPTH_RTOL = 0, 1e-3
VITL = dict(embed_dim=1024, depth=24, num_heads=16, patch_size=14,
            taps=(4, 11, 17), exact_gelu=True, use_cls_token=True,
            layerscale=True, final_norm=True)
VITL_SIDE = 518
# depth_chain and chain: the train CLI's iterations on the chain's own
# priors.
CHAIN_ITERS = 300
# chain: the native reader's model at a Mip-NeRF 360 capture's size: images
# x 2D points each, points x track length (each way 2M observations).
NATIVE_IMAGES, NATIVE_P2D = 200, 10_000
NATIVE_POINTS, NATIVE_TRACK = 200_000, 10
# viewer: requests per camera in-process, the train CLI run's iterations
# with a client that holds training for VIEWER_HELD requests.
VIEWER_REQUESTS, VIEWER_CLI_ITERS, VIEWER_HELD = 10, 100, 3
# depth_train: the repo's depth configuration (DEPTH_SEED's weights, max
# depth 8 m as the proof's) on DEPTH_CHECK views of the raycast scene, its
# DEPTH_CHECK_STEPS steps on the card against the CPU and with the plain
# attention form against the fused one (losses within DEPTH_LOSS_RTOL,
# parameters at the Adam tolerance of utils/testing.py::adam_agreement);
# then docs/DEPTH_RUN_r05.md's recipe (ViT-768 x 12, DPT decoder, 64
# normed bins, 256², batch 8, 400 steps, lr 3e-4; 40 + 8 raycast views)
# through depth_train_proof at full width.
DEPTH_CHECK, DEPTH_CHECK_SIDE, DEPTH_CHECK_STEPS = 4, 128, 3
DEPTH_LOSS_RTOL = 1e-4
DEPTH_R05 = ["400", "256", "8", "--embed_dim", "768", "--encoder_depth",
             "12", "--n_bins", "64", "--bin_centers_type", "normed", "--lr",
             "3e-4", "--tag", "smoke"]
# depth_dp (--ranks): the repo's configuration at 256² over DP_VIEWS raycast
# views, global batch 8 (8 / N a rank), the first 20 steps of the recipe's
# 400-step OneCycle schedule, against one rank. (At the peak rate of a
# 20-step schedule the losses of one rank alone move by 1e-3 within five
# steps with the thread count of the CPU's reductions: rounding-level
# differences grow there, whatever computes them.)
DP_SIDE, DP_VIEWS, DP_BATCH, DP_STEPS, DP_SCHEDULE = 256, 16, 8, 20, 400
# The phases that --phases may select, in their order; all but
# depth_train use train_cli's scene.
CLI_PHASES = ("train_cli", "mesh_train", "thesis", "metrics", "depth",
              "depth_chain", "chain", "viewer", "depth_train")
# ... and with --ranks N.
RANK_PHASES = ("multi_rank", "multi_cli", "depth_dp")
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(torch, fn, reps: int = 20, warmup: bool = True,
            queued: bool = False) -> float:
    """Mean ms per call of `fn` on the card, by CUDA events. With `queued`
    the card first spins ~5 ms while the host enqueues the calls, so that
    a call shorter than its own host time is timed on the card and not
    paced by the host."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


@contextlib.contextmanager
def swapped(attrs):
    """Replace module attributes [(module, name, value)] for the block."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in attrs]
    for m, n, v in attrs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def bound(nbytes: float, ops: float):
    """(least ms, what bounds it) for moving `nbytes` and doing `ops` f32
    operations on the card."""
    tb = nbytes / CARD_BYTES_PER_S * 1e3
    to = ops / CARD_F32_OPS_PER_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def run_readings(events, lo: int, hi: int):
    """A training run's held-out and train PSNR by iteration, and its it/s
    between iterations lo and hi, from its ``events.jsonl`` records:
    ``iter_time`` is the ms per iteration of the drained block of 50
    iterations that holds its step, logged every 10."""
    def tag(name):
        return {e["step"]: e["value"] for e in events if e.get("tag") == name}
    ms = [v for it, v in tag("iter_time").items() if lo < it <= hi]
    return (tag("test/loss_viewpoint - psnr"),
            tag("train/loss_viewpoint - psnr"),
            1e3 * len(ms) / sum(ms))


def random_vgg16_npz(path: str, seed: int = 0) -> None:
    """VGG16-shaped random LPIPS weights (torchvision's feature indices,
    the five linear heads), drawn with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    arrays, cin, layer = {}, 3, 0
    for item in [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M"]:
        if item == "M":
            layer += 1
            continue
        arrays[f"features.{layer}.weight"] = (rng.standard_normal(
            (item, cin, 3, 3), dtype=np.float32) / np.sqrt(9 * cin))
        arrays[f"features.{layer}.bias"] = 0.1 * rng.standard_normal(
            item, dtype=np.float32)
        cin, layer = item, layer + 2
    for k, c in enumerate((64, 128, 256, 512, 512)):
        arrays[f"lin{k}.model.1.weight"] = np.abs(rng.standard_normal(
            (1, c, 1, 1), dtype=np.float32)) / c
    np.savez(path, **arrays)


def read_events(model: str) -> list:
    with open(os.path.join(model, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def viewer_session(port: int, message: dict, held: int = VIEWER_HELD,
                   deadline: float = 600.0) -> dict:
    """A SIBR-like client of a train CLI's viewer on `port`: `held`
    requests with ``train: false`` (training held: one iteration, equal
    images), one that resumes training, one from a later iteration; each
    must bring back an image. Raises if the viewer cannot be reached
    within `deadline` s or drops a request. Pick `port` with
    ``free_port_below_ephemeral``: the client dials it before the CLI
    binds it, while NCCL's and gloo's listeners take ephemeral ports."""
    from priordepth_gaussiansplatting_torch.utils import testing
    client = testing.connect_viewer(port, deadline)
    try:
        images = [client.request(dict(message, train=False))[0]
                  for _ in range(held)]
        images.append(client.request(message)[0])
        images.append(client.request(message)[0])
    finally:
        client.close()
    assert all(im is not None and im.std() > 0 for im in images)
    assert all(np.array_equal(im, images[0]) for im in images[1:-1]), (
        "the held requests' images differ: training went on")
    assert not np.array_equal(images[-1], images[0]), (
        "the request after resuming shows the held state")
    return {"requests": len(images), "held": held,
            "shape": list(images[0].shape)}


class Client(threading.Thread):
    """`viewer_session` in a thread; ``result()`` re-raises its error."""

    def __init__(self, *args):
        super().__init__(daemon=True)
        self.args, self.out, self.err = args, None, None

    def run(self):
        try:
            self.out = viewer_session(*self.args)
        except Exception as e:  # re-raised by result()
            self.err = e

    def result(self, timeout: float = 120.0) -> dict:
        self.join(timeout)
        if self.is_alive():
            raise RuntimeError("the viewer client did not finish")
        if self.err is not None:
            raise RuntimeError(f"the viewer client failed: {self.err!r}")
        return self.out


class Smoke:
    def __init__(self):
        import torch

        from priordepth_gaussiansplatting_torch import kernels, interop
        from priordepth_gaussiansplatting_torch.ops import (binning,
                                                            projection,
                                                            rasterize, render)
        from priordepth_gaussiansplatting_torch.models import densify
        from priordepth_gaussiansplatting_torch.train import optim, step
        from priordepth_gaussiansplatting_torch.utils import config, testing
        self.torch, self.kernels, self.interop = torch, kernels, interop
        self.binning, self.projection = binning, projection
        self.rasterize, self.render, self.testing = rasterize, render, testing
        self.densify, self.optim, self.step, self.config = (densify, optim,
                                                            step, config)
        self.dev = torch.device("cuda")
        self.results = {}

    # --- inputs ------------------------------------------------------------

    def state(self, g, num_images: int = 1):
        t = self.torch
        params = {
            "xyz": g["means"], "features_dc": g["sh"][:, :3],
            "features_rest": g["sh"][:, 3:], "scaling": np.log(g["scales"]),
            "rotation": g["quats"],
            "opacity": np.log(g["opacities"] / (1 - g["opacities"]))[:, None],
            "exposure": np.tile(np.eye(3, 4, dtype=np.float32),
                                (num_images, 1, 1)),
        }
        n = g["means"].shape[0]
        state = self.interop.gaussian_state_from_numpy(
            params, np.ones(n, bool), 3, 3, device=self.dev)
        t.cuda.synchronize()
        return state

    def train_cameras(self, eyes, w, h, seed):
        """Views with a uniform random target and a random inverse-depth
        prior (mask all ones), drawn with numpy from `seed`; view i uses
        exposure i."""
        rng = np.random.default_rng(seed)
        return [self.testing.look_at_camera(
            e, width=w, height=h, device=self.dev, exposure_id=i,
            image=rng.random((3, h, w), dtype=np.float32),
            invdepth=rng.uniform(0.2, 0.6, (h, w)).astype(np.float32),
            depth_mask=np.ones((h, w), np.float32))
            for i, e in enumerate(eyes)]

    def project(self, cam, state):
        return self.projection.project_gaussians(
            state.params.xyz, state.get_covariance(), state.get_opacity(),
            state.get_features(), state.max_sh_degree, cam.world_view,
            cam.full_proj, cam.cam_center, cam.width, cam.height,
            cam.tan_fovx, cam.tan_fovy, antialiasing=True,
            valid_mask=state.active)

    def capacities(self, proj, w, h, headroom: float = 1.05):
        """One probe binning, then the ladder rung above
        `headroom` times the rect and the kept pair counts."""
        rp = self.rasterize
        total = int(self.binning.depth_sorted_rects(proj, w, h)["total"])
        probe = max(rp.default_pair_capacity(proj.mean2d.shape[0]),
                    rp.round_capacity(total))
        _, aux = self.binning.bin_sorted_pairs(proj, w, h, probe)
        return (rp.round_capacity(int(int(aux["num_rect"]) * headroom)),
                rp.round_capacity(int(int(aux["num_valid"]) * headroom)))

    def view_capacities(self, state, cams, headroom: float = 1.05):
        """The largest capacities over the views."""
        with self.torch.no_grad():
            caps = [self.capacities(self.project(c, state), c.width,
                                    c.height, headroom) for c in cams]
        return max(c[0] for c in caps), max(c[1] for c in caps)

    def plain_kernels(self):
        """Every kernel wrapper of the path replaced by its plain version,
        so the same autograd Functions run on the card without a kernel."""
        b, r = self.binning, self.rasterize
        return swapped([
            (b, "expand_pairs", b.expand_pairs_plain),
            (b, "expand_tiles", b.expand_tiles_plain),
            (b, "gather_rows", b.gather_rows_plain),
            (b, "sort_back_rows", b.sort_back_rows_plain),
            (b, "segment_reduce", b.segment_reduce_plain),
            (r, "composite_fwd", r.composite_fwd_plain),
            (r, "composite_bwd", r.composite_bwd_plain),
            (r, "composite_fwd_bands", r.composite_fwd_bands_plain),
            (r, "composite_bwd_bands", r.composite_bwd_bands_plain)])

    def recording(self, store):
        """The backward kernels' wrappers, recording their arguments
        (detached: the forward's outputs that K3 reads need a gradient)."""
        b, r = self.binning, self.rasterize

        def rec(name, fn):
            def call(*args, **kw):
                store[name] = (tuple(a.detach() if isinstance(
                    a, self.torch.Tensor) else a for a in args), kw)
                return fn(*args, **kw)
            return call
        return swapped([(m, n, rec(n, getattr(m, n))) for m, n in
                        ((r, "composite_bwd"), (b, "pair_grads_to_gaussians"),
                         (b, "sort_back_rows"), (b, "segment_reduce"))])

    def sample_tiles(self, ts, te, seed: int = 0):
        """The 32 busiest tiles and 32 others drawn from `seed` (int32)."""
        counts = (te - ts).cpu().numpy()
        busiest = np.argsort(-counts, kind="stable")[:32]
        rest = np.setdiff1d(np.arange(counts.size), busiest)
        rng = np.random.default_rng(seed)
        pick = np.concatenate([busiest, rng.choice(rest, 32, False)])
        return self.torch.as_tensor(pick, dtype=self.torch.int32,
                                    device=self.dev)

    def gather_orders(self, call, queued: bool = False) -> dict:
        """{rows per pass: ms of `call`}: the gather kernel walking one row
        per pass, the path's number, and every row at once (its first
        walk)."""
        b = self.binning
        out = {}
        for rpp in sorted({1, b.GATHER_ROWS_PER_PASS, b.ATTR_ROWS + 1}):
            with swapped([(b, "GATHER_ROWS_PER_PASS", rpp)]):
                out[rpp] = cuda_ms(self.torch, call, queued=queued)
        return out

    def used_evaluations(self, table, ts, te, grid_x):
        """Per tile, the (pixel, pair) evaluations of kept pairs before each
        pixel's stop: the evaluations K3 does its extra work for (int64,
        one per tile)."""
        t, b, r = self.torch, self.binning, self.rasterize
        total = t.zeros(ts.shape[0], dtype=t.int64, device=self.dev)
        for tile, (s, e) in enumerate(zip(ts.tolist(), te.tolist())):
            if e <= s:
                continue
            ty, tx = divmod(tile, grid_x)
            pix = t.arange(r.PIX, device=self.dev)
            px = (tx * 16 + pix % 16).float()[:, None]
            py = (ty * 16 + pix // 16).float()[:, None]
            p = table[:, s:e]
            dx, dy = px - p[b.ATTR_MX], py - p[b.ATTR_MY]
            power = (-0.5 * (p[b.ATTR_CA] * dx * dx + p[b.ATTR_CC] * dy * dy)
                     - p[b.ATTR_CB] * dx * dy)
            alpha = t.clamp_max(p[b.ATTR_OP] * t.exp(power), r.ALPHA_MAX)
            keep = (power <= 0.0) & (alpha >= r.ALPHA_MIN)
            a = t.where(keep, alpha, t.zeros_like(alpha))
            live = t.cumprod(1.0 - a, dim=1) >= r.T_EPS
            total[tile] = (keep & live).sum()
        return total

    def walk_stats(self, table, ts, te, grid_x, n_used: int) -> dict:
        """How many of a tile's four warps walk a pair in K2 and K3 (their
        warp lists, from the plain form ``walking_warps_plain``), and how
        many of a walked warp's 64 pixels keep the pair on average."""
        walks = self.rasterize.walking_warps_plain(table, ts, te, grid_x)
        walked = sum(int(((walks >> w) & 1).sum()) for w in range(4))
        pairs = int((te - ts).clamp_min(0).sum())
        return dict(pairs=pairs, walked_warps_per_pair=walked / pairs,
                    kept_pixels_per_walked_warp=n_used / walked)

    def check_k4(self, ds, ks, num_valid, n) -> dict:
        """K4 on its inputs from a step: two launches equal bit for bit,
        within 1e-5 max|row| of its plain version (a float64 sum), and its
        time (CUDA events) beside its plain version's, its bound (40 bytes
        per valid pair, 4 per key, 40 per Gaussian) and its yardsticks: the
        one PyTorch call that computes its function, ``torch.segment_reduce``
        over each Gaussian's segment (the offsets, from ``segment_bounds``,
        made before the timed calls), and the float ``index_add_`` that the
        earlier PRs named."""
        t, b = self.torch, self.binning
        rows, v = ds.shape
        got = b.segment_reduce(ds, ks, num_valid, n)
        again = b.segment_reduce(ds, ks, num_valid, n)
        want = b.segment_reduce_plain(ds, ks, num_valid, n)
        offsets = b.segment_bounds(ks, num_valid, n).long().expand(
            rows, n + 1)

        def library():
            return t.segment_reduce(ds, "sum", offsets=offsets, axis=1)
        lib = library()
        t.cuda.synchronize()
        assert bits_equal(t, got, again), "K4 is not deterministic"
        scale = want.abs().amax(1, keepdim=True)
        assert bool(((got - want).abs() <= 1e-5 * scale).all()), "K4"
        assert bool(((lib - want).abs() <= 1e-5 * scale).all()), \
            "torch.segment_reduce"
        pos = t.arange(v, device=ds.device)
        idx = t.where((pos < num_valid) & (ks < n), ks, n).long()
        nv = min(int(num_valid), v)
        bound_ms, bound_by = bound(40 * nv + 4 * v + 40 * n, 10 * nv)
        # queued: K4 can run shorter than its wrapper's host time
        return dict(
            n=n, v=v, num_valid=nv,
            max_abs_err=float((got - want).abs().max()),
            share_bit_equal_plain=float(
                (got.view(t.int32) == want.view(t.int32)).float().mean()),
            ms=cuda_ms(t, lambda: b.segment_reduce(ds, ks, num_valid, n),
                       queued=True),
            plain_ms=cuda_ms(t, lambda: b.segment_reduce_plain(
                ds, ks, num_valid, n), reps=3),
            library_ms=cuda_ms(t, library, queued=True),
            index_add_ms=cuda_ms(t, lambda: t.zeros(
                rows, n + 1, device=ds.device).index_add_(1, idx, ds),
                queued=True),
            bound_ms=bound_ms, bound_by=bound_by)

    # --- kernel vs plain -----------------------------------------------------

    def check_kernels(self, proj, w, h, p_cap, v_cap, tiles=None):
        """Each kernel against its plain version on the main path's
        intermediates. Returns the per-kernel errors and the inputs."""
        t, b, r = self.torch, self.binning, self.rasterize
        grid_x, grid_y = b.grid_shape(w, h)
        num_tiles = grid_x * grid_y
        rects = b.depth_sorted_rects(proj, w, h)
        k1_args = dict(rects, p_cap=p_cap, grid_x=grid_x, num_tiles=num_tiles)
        got = b.expand_pairs(**k1_args)
        want = b.expand_pairs_plain(**k1_args)
        t.cuda.synchronize()
        tile, gid, attrs, hist = got
        assert bits_equal(t, gid, want[1]), "K1 gaussian ids differ"
        assert bits_equal(t, attrs, want[2]), "K1 attributes differ"
        flips = tile != want[0]
        n_flips = int(flips.sum())
        if n_flips:
            real = t.where(tile == num_tiles, want[0], tile)[flips]
            qmin, limit = b.cull_terms(real, attrs[:, flips], grid_x)
            ulp = t.nextafter(limit, t.full_like(limit, float("inf"))) - limit
            assert bool(((qmin - limit).abs() <= ulp).all()), \
                "K1 culls differ away from the cull limit"
        num_rect = int(rects["total"])
        assert n_flips <= 1e-5 * num_rect, f"K1: {n_flips} cull flips"
        for out, name in ((tile, "kernel"), (want[0], "plain")):
            kept = out[out < num_tiles].long()
            ref_hist = t.bincount(kept, minlength=num_tiles).to(t.int32)
            h_out = hist if name == "kernel" else want[3]
            assert bits_equal(t, h_out, ref_hist), f"K1 {name} histogram"

        ends = t.cumsum(hist, 0).to(t.int32)
        ts = t.clamp_max(ends - hist, v_cap)
        te = t.clamp_max(ends, v_cap)
        perm = t.sort(tile, stable=True).indices
        out_len = v_cap + b.COMPOSITE_PAD
        table, gid_sorted = b.gather_rows(attrs, gid, perm, v_cap, out_len)
        table_p, gid_p = b.gather_rows_plain(attrs, gid, perm, v_cap, out_len)
        t.cuda.synchronize()
        assert bits_equal(t, table, table_p), "K5 table differs"
        assert bits_equal(t, gid_sorted, gid_p), "K5 ids differ"

        sel = None if tiles is None else tiles(ts, te)
        k2 = r.composite_fwd(table, ts, te, grid_x, tiles=sel)
        k2_p = r.composite_fwd_plain(table, ts, te, grid_x, tiles=sel)
        t.cuda.synchronize()
        k2_err = 0.0
        for got_o, want_o, name in zip(k2[:3], k2_p[:3],
                                       ("colour", "invdepth", "final_T")):
            diff = (got_o - want_o).abs()
            close = float((diff <= 2e-5).float().mean())
            k2_err = max(k2_err, float(diff.max()))
            assert close >= 0.999 and float(diff.max()) <= 5e-3, \
                (f"K2 {name}: {close} within 2e-5, max {float(diff.max())}")
        n_eval_same = float((k2[3] == k2_p[3]).float().mean())
        assert n_eval_same >= 0.999, f"K2 pairs evaluated: {n_eval_same}"
        errs = {"expand_pairs": float((attrs - want[2]).abs().max()),
                "gather_rows": float((table - table_p).abs().max()),
                "composite_fwd": k2_err}
        inputs = dict(k1=k1_args, attrs=attrs, gid=gid, perm=perm,
                      v_cap=v_cap, out_len=out_len, table=table, ts=ts,
                      te=te, grid_x=grid_x, tiles=sel)
        return errs, inputs, dict(cull_flips=n_flips, num_rect=num_rect,
                                  num_valid=int(ends[-1]),
                                  k2_tiles=int(k2[0].shape[1]),
                                  k2_n_eval_equal=n_eval_same)

    # --- phases --------------------------------------------------------------

    def phase_device(self, build_seconds, build_wall):
        t = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        from priordepth_gaussiansplatting_torch.kernels import build
        nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[-1]
        ptxas = {}
        for name in self.kernels.KERNELS:
            lines = [ln.split("ptxas info    :")[-1].strip()
                     for ln in build.ptxas_report(name).splitlines()
                     if "Used" in ln or "spill" in ln]
            ptxas[name] = lines
        # Resident blocks and warps per SM of the compositor's four entry
        # points, K1 and K7, and K4 at the ids per block of the mid and the
        # full scene and at the most (CUDA occupancy calculator).
        occupancy = {}
        outp = [ctypes.POINTER(ctypes.c_int)]
        queries = [(name, second, f"{name}_occupancy", outp, ())
                   for name, second in (("composite_fwd",
                                         "composite_fwd_bands"),
                                        ("composite_bwd",
                                         "composite_bwd_bands"),
                                        ("expand_pairs", "expand_tiles"))]
        queries += [("segment_reduce", f"segment_reduce_scalar_g{ids}",
                     "segment_reduce_occupancy", [ctypes.c_int] + outp,
                     (ids,)) for ids in (128, 1024)]
        for name, second, fn, argtypes, args in queries:
            out = (ctypes.c_int * 3)()
            rc = build.entry(name, fn, argtypes)(*args, out)
            assert rc == 0, (name, rc)
            first = name if not args else f"{name}_g{args[0]}"
            for label, blocks in ((first, out[0]), (second, out[1])):
                assert blocks >= 1, (label, blocks)
                occupancy[label] = dict(threads_per_block=out[2],
                                        blocks_per_sm=blocks,
                                        warps_per_sm=blocks * out[2] // 32)
        # K7 runs persistent blocks: its blocks per SM, grid, dynamic shared
        # memory (the histogram) at the full scene's shape.
        gx, gy = self.binning.grid_shape(FULL_W, FULL_H)
        shape = self.binning.expand_tiles_grid(BIN_P, gx * gy)
        assert shape["blocks_per_sm"] >= 1 and shape["shared_hist"], shape
        occupancy["expand_tiles_full_scene"] = dict(
            shape, threads_per_block=256,
            warps_per_sm=shape["blocks_per_sm"] * 8)
        # The port switches TF32 off when it is imported: the projection's
        # products and SSIM's convolutions run in true f32.
        tf32 = {"matmul": t.backends.cuda.matmul.allow_tf32,
                "cudnn": t.backends.cudnn.allow_tf32}
        assert not any(tf32.values()), tf32
        self.smi = smi
        emit("device", name=t.cuda.get_device_name(0),
             count=t.cuda.device_count(), nvidia_smi=smi, nvcc=nvcc,
             torch=t.__version__, torch_cuda=t.version.cuda,
             build_s={k: round(v, 3) for k, v in build_seconds.items()},
             build_wall_s=round(build_wall, 3), ptxas=ptxas,
             occupancy=occupancy, allow_tf32=tf32)

    def phase_mid(self):
        T = self.testing
        out = {}
        for label, g, wh, eye in (
                (f"n{MID_N}_{MID_WH}px", T.random_gaussians(1, MID_N), MID_WH,
                 (0.0, 0.0, -2.5)),
                ("dense_overlap", T.random_gaussians(
                    5, 128, extent=0.3, scale_range=(0.1, 0.3),
                    opacity_range=(0.9, 0.99)), 48, (0.0, 0.0, -2.0))):
            state = self.state(g)
            cam = T.look_at_camera(eye, width=wh, height=wh, device=self.dev)
            proj = self.project(cam, state)
            p_cap, v_cap = self.capacities(proj, wh, wh)
            errs, x, info = self.check_kernels(proj, wh, wh, p_cap, v_cap)
            out[label] = dict(max_abs_err=errs, p_cap=p_cap, v_cap=v_cap,
                              **info, **self.check_composite_pair(
                                  x, timed=label != "dense_overlap"))
        emit("mid", ok=True, **out)

    def check_k3_tiles(self, args, d_full, sel) -> dict:
        """K3 over the listed tiles `sel` (int32) with `args` (K3's
        arguments over all tiles, whose table `d_full` is): equal to
        `d_full` on their columns bit for bit, nothing written outside
        them, and within K3's rule of its plain version."""
        t, r = self.torch, self.rasterize
        table, ts, te, grid_x = args[:4]
        sub = [c[..., sel, :].contiguous() for c in args[4:]]
        got, got_eval = r.composite_bwd(table, ts, te, grid_x, *sub,
                                        tiles=sel)
        want, want_eval = r.composite_bwd_plain(table, ts, te, grid_x, *sub,
                                                tiles=sel)
        cols = t.cat([t.arange(s, e, device=self.dev) for s, e in
                      zip(ts[sel].tolist(), te[sel].tolist())])
        assert bits_equal(t, got[:, cols], d_full[:, cols]), \
            "K3 over listed tiles differs from K3 over all tiles"
        a, w = got[:, cols], want[:, cols]
        within = ((a - w).abs() <= GRAD_ATOL * w.abs().amax(1, keepdim=True)
                  + GRAD_RTOL * w.abs()).float().mean(1)
        assert float(within.min()) >= 0.999, f"K3 rows: {within.tolist()}"
        assert float((got_eval == want_eval).float().mean()) >= 0.999
        outside = got.clone()
        outside[:, cols] = 0.0
        assert float(outside.abs().max()) == 0.0, \
            "K3 wrote outside the listed tiles"
        return dict(k3_tiles_checked=int(sel.shape[0]),
                    k3_rows_within=within.tolist(),
                    k3_max_abs_err=float((a - w).abs().max()))

    def check_composite_pair(self, x, timed: bool) -> dict:
        """K3 over the whole frame of `x` (check_kernels' inputs) from
        random cotangents: two launches equal bit for bit, its evaluated
        pairs equal K2's on every pixel, and K3's rule against its plain
        version on sampled tiles (all tiles of a small frame; see
        check_k3_tiles). With `timed`, K2's and K3's times beside their
        bounds."""
        t, r = self.torch, self.rasterize
        table, ts, te, grid_x = x["table"], x["ts"], x["te"], x["grid_x"]
        nt = int(ts.shape[0])
        fwd = r.composite_fwd(table, ts, te, grid_x)
        gen = t.Generator(device=self.dev).manual_seed(3)
        cts = [t.randn(c, nt, r.PIX, generator=gen, device=self.dev)
               for c in (3, 1, 1)]
        args = (table, ts, te, grid_x, cts[0], cts[1][0], cts[2][0],
                *fwd[:3])
        d1, e1 = r.composite_bwd(*args)
        d2, e2 = r.composite_bwd(*args)
        t.cuda.synchronize()
        assert bits_equal(t, d1, d2) and bits_equal(t, e1, e2), \
            "K3 is not deterministic"
        differ = int((e1 != fwd[3]).sum())
        assert differ == 0, f"K3 evaluated pairs differ from K2's on {differ}"
        out = self.check_k3_tiles(args, d1, self.sample_tiles(ts, te)
                                  if nt > 64 else t.arange(
                                      nt, dtype=t.int32, device=self.dev))
        if timed:
            n_evals = int(fwd[3].sum())
            n_used = int(self.used_evaluations(table, ts, te, grid_x).sum())
            nv = int(te.max())
            length = table.shape[1]
            out.update(
                n_evals=n_evals, n_used=n_used,
                walk=self.walk_stats(table, ts, te, grid_x, n_used),
                ms={"composite_fwd": cuda_ms(t, lambda: r.composite_fwd(
                    table, ts, te, grid_x)),
                    "composite_bwd": cuda_ms(t, lambda: r.composite_bwd(
                        *args))},
                bound_ms={
                    "composite_fwd": bound(40 * nv + 8 * nt + 24 * 256 * nt,
                                           K2_OPS_PER_EVAL * n_evals)[0],
                    "composite_bwd": bound(
                        40 * nv + 40 * length + 8 * nt + 44 * 256 * nt,
                        K2_OPS_PER_EVAL * n_evals
                        + K3_OPS_PER_USED * n_used)[0]})
        return out

    def phase_full(self):
        t, T, k = self.torch, self.testing, self.kernels
        g = T.random_gaussians(0, FULL_N, extent=1.0,
                               scale_range=(0.001, 0.004))
        state = self.state(g)
        cams = [T.look_at_camera(e, width=FULL_W, height=FULL_H,
                                 device=self.dev) for e in FULL_EYES]
        caps = [self.capacities(self.project(c, state), FULL_W, FULL_H)
                for c in cams]
        p_cap = max(c[0] for c in caps)
        v_cap = max(c[1] for c in caps)
        bg = t.zeros(3, device=self.dev)
        self.full = dict(state=state, cams=cams, p_cap=p_cap, v_cap=v_cap)

        def render(cam):
            return self.render.render(cam, state, bg, antialiasing=True,
                                      backend="kernels", pair_capacity=p_cap,
                                      valid_capacity=v_cap)

        # The main path: every count at 0 just before, read just after.
        t.cuda.synchronize()
        k.reset_launch_counts()
        per_view, outs = [], []
        for cam in cams:
            before = k.launch_counts()
            out = render(cam)
            t.cuda.synchronize()
            after = k.launch_counts()
            per_view.append({n: after[n] - before[n] for n in FORWARD})
            outs.append(out)
        launches = k.launch_counts()
        for i, (view, out) in enumerate(zip(per_view, outs)):
            assert all(view[n] >= 1 for n in FORWARD), (i, view)
            img = out["render"]
            assert img.shape == (3, FULL_H, FULL_W)
            assert bool(t.isfinite(img).all()) and bool(
                t.isfinite(out["invdepth"]).all()), f"view {i}: non-finite"
            assert int(out["overflow"]) == 0, f"view {i} overflowed"
            assert float(img.std()) > 0 and int(out["num_pairs"]) > 0
        assert all(launches[n] == len(cams) for n in FORWARD), launches

        # Kernels against plain versions on view 0's intermediates.
        proj0 = self.project(cams[0], state)
        errs, x, info = self.check_kernels(proj0, FULL_W, FULL_H, p_cap,
                                           v_cap, tiles=self.sample_tiles)

        # Times on the card (CUDA events), at the main path's shapes.
        b, r = self.binning, self.rasterize

        def k5a():
            return b.gather_rows(x["attrs"], x["gid"], x["perm"], x["v_cap"],
                                 x["out_len"])
        ms = {
            # queued: K1 runs about as long as its wrapper's host time
            "expand_pairs": cuda_ms(t, lambda: b.expand_pairs(**x["k1"]),
                                    queued=True),
            "gather_rows": cuda_ms(t, k5a),
            "composite_fwd": cuda_ms(t, lambda: r.composite_fwd(
                x["table"], x["ts"], x["te"], x["grid_x"])),
        }
        plain_ms = {
            "expand_pairs": cuda_ms(t, lambda: b.expand_pairs_plain(**x["k1"]),
                                    reps=3),
            "gather_rows": cuda_ms(t, lambda: b.gather_rows_plain(
                x["attrs"], x["gid"], x["perm"], x["v_cap"], x["out_len"]),
                reps=3),
        }
        full_plain = {}

        def k2_plain():
            full_plain["out"] = r.composite_fwd_plain(x["table"], x["ts"],
                                                      x["te"], x["grid_x"])
        plain_ms["composite_fwd"] = cuda_ms(t, k2_plain, reps=1,
                                            warmup=False)
        head = x["perm"][:x["v_cap"]]

        def library_k5():
            t.nn.functional.pad(x["attrs"].index_select(1, head),
                                (0, x["out_len"] - x["v_cap"]))
            x["gid"].index_select(0, head)
        library_ms = {"expand_pairs": None, "composite_fwd": None,
                      "gather_rows": cuda_ms(t, library_k5)}

        # The whole image of view 0 against the plain compositor.
        k2_full = r.composite_fwd(x["table"], x["ts"], x["te"], x["grid_x"])
        for got_o, want_o in zip(k2_full[:3], full_plain["out"][:3]):
            diff = (got_o - want_o).abs()
            assert float((diff <= 2e-5).float().mean()) >= 0.999
            assert float(diff.max()) <= 5e-3
        n_evals = int(k2_full[3].sum())

        # Least time for each kernel's work on this run's data.
        tot = min(info["num_rect"], p_cap)
        offsets = x["k1"]["offsets"]
        n_live = int((t.diff(offsets, append=x["k1"]["total"]) > 0).sum())
        num_tiles = int(x["ts"].shape[0])
        nv = min(info["num_valid"], v_cap)
        # K1 writes 12 words to every slot up to p_cap (the padding slots'
        # tile, -1 id and zero rows too) and reads each live Gaussian's 14.
        work = {
            "expand_pairs": (48 * p_cap + 56 * n_live + 4 * num_tiles + 4,
                             K1_OPS_PER_SLOT * tot),
            "gather_rows": (8 * x["v_cap"] + 44 * x["v_cap"]
                            + 40 * x["out_len"] + 4 * x["v_cap"], 0),
            "composite_fwd": (40 * nv + 8 * num_tiles
                              + 6 * 4 * num_tiles * 256,
                              K2_OPS_PER_EVAL * n_evals),
        }
        bound_ms, bound_by = {}, {}
        for name, (nbytes, ops) in work.items():
            bound_ms[name], bound_by[name] = bound(nbytes, ops)
        gather = dict(ms=ms["gather_rows"],
                      library_ms=library_ms["gather_rows"],
                      plain_ms=plain_ms["gather_rows"],
                      bound_ms=bound_ms["gather_rows"],
                      rows_per_pass_ms=self.gather_orders(k5a))

        # The whole render, end to end, forward only.
        render(cams[0])
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            for cam in cams:
                render(cam)
        t.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3 / (reps * len(cams))
        self.results.update(errs=errs, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        emit("full", ok=True, n=FULL_N, width=FULL_W, height=FULL_H,
             views=len(cams), p_cap=p_cap, v_cap=v_cap,
             launches_per_view=per_view, launches=launches,
             num_pairs=[int(o["num_pairs"]) for o in outs],
             num_rect=info["num_rect"], cull_flips=info["cull_flips"],
             k2_tiles_checked=info["k2_tiles"], max_abs_err=errs,
             gather=gather,
             n_evals=n_evals, ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
             render_ms_per_frame=frame_ms,
             mray_per_s=FULL_W * FULL_H / frame_ms / 1e3,
             peak_mem_gib=t.cuda.max_memory_allocated() / 2 ** 30)
        self.phase_profile(render, cams)

    def phase_profile(self, fn, cams, phase: str = "profile"):
        """Where a frame's time goes (see :meth:`profile`), as a phase."""
        emit(phase, **self.profile(fn, cams))

    def profile(self, fn, cams) -> dict:
        """Device time by kernel name and host time by operator, from
        torch.profiler over one call of `fn` per view."""
        t = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn(cams[0])
        t.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for cam in cams:
                fn(cam)
            t.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        frames = len(cams)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                acc = by_name.setdefault(e.name, [0.0, 0])
                acc[0] += e.time_range.elapsed_us() / 1e3
                acc[1] += 1
        device_ms = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
        host = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:10]
        return dict(
            frames=frames, traced_wall_ms_per_frame=wall_ms / frames,
            device_ms_per_frame=device_ms / frames,
            device_busy_share=device_ms / wall_ms,
            device_ops_per_frame=sum(v[1] for v in by_name.values()) / frames,
            device_top=[{"name": n[:100], "ms_per_frame": v[0] / frames,
                         "calls_per_frame": v[1] / frames} for n, v in top],
            host_top=[{"name": e.key[:60],
                       "self_ms_per_frame":
                           e.self_cpu_time_total / 1e3 / frames,
                       "calls_per_frame": e.count / frames} for e in host])

    # --- training ------------------------------------------------------------

    def train_fns(self, p_cap, v_cap, use_trained_exp=False):
        cfg = self.config
        return self.step.make_train_step(
            cfg.OptimizationConfig(depth_feedback=True),
            cfg.PipelineConfig(antialiasing=True, backend="kernels"),
            use_trained_exp=use_trained_exp, pair_capacity=p_cap,
            valid_capacity=v_cap)

    def checked_step(self, fns, state, opt, cam, it, bg, label,
                     groups=None, path=STEP):
        """One train step with its launch counts (one of each kernel of
        `path`, none of the others), guard and gradients (of `groups`,
        default all) checked. The gradient of each group is read back from
        Adam's first moment (mu' = 0.9 mu + 0.1 g)."""
        t, k = self.torch, self.kernels
        mu0 = {n: getattr(opt.mu, n).clone()
               for n in groups or self.interop.PARAM_FIELDS}
        accum0 = float(state.xyz_gradient_accum.sum())
        before = k.launch_counts()
        state, opt, m = fns.step(state, opt, cam, it, None, bg)
        t.cuda.synchronize()
        after = k.launch_counts()
        delta = {n: after[n] - before[n] for n in KERNELS}
        assert delta == {n: int(n in path) for n in KERNELS}, \
            (label, it, delta)
        m = {key: float(v) for key, v in m.items()}
        assert m["skipped"] == 0 and m["overflow"] == 0, (label, it, m)
        assert np.isfinite(m["loss"]), (label, it, m)
        b1 = self.optim.B1
        for n, old in mu0.items():
            g = (getattr(opt.mu, n) - b1 * old) / (1.0 - b1)
            assert bool(t.isfinite(g).all()), (label, it, n, "non-finite")
            assert bool((g != 0).any()), (label, it, n, "all zero")
        assert float(state.xyz_gradient_accum.sum()) > accum0, (label, it)
        return state, opt, m

    def phase_train(self):
        t, T, k = self.torch, self.testing, self.kernels
        b, r = self.binning, self.rasterize
        g = T.random_gaussians(0, FULL_N, extent=1.0,
                               scale_range=(0.001, 0.004))
        state = self.state(g, num_images=len(FULL_EYES))
        cams = self.train_cameras(FULL_EYES, FULL_W, FULL_H, seed=1)
        # 1.25x headroom: Adam grows these small Gaussians towards the
        # random target over the ten steps, and with them the pair count.
        p_cap, v_cap = self.view_capacities(state, cams, headroom=1.25)
        fns = self.train_fns(p_cap, v_cap, use_trained_exp=True)
        opt = self.optim.init_adam(state.params)
        bg = t.zeros(3, device=self.dev)

        # The main path: every count at 0 just before, read just after.
        store = {}
        t.cuda.synchronize()
        k.reset_launch_counts()
        steps = []
        for i in range(TRAIN_STEPS):
            cam = cams[i % len(cams)]
            with self.recording(store) if i == 0 else contextlib.nullcontext():
                state, opt, m = self.checked_step(fns, state, opt, cam, i + 1,
                                                  bg, "train")
            steps.append({key: m[key] for key in
                          ("loss", "l1", "ssim", "depth_loss", "n_visible",
                           "num_pairs")})
        launches = k.launch_counts()
        assert all(launches[n] == TRAIN_STEPS for n in STEP), launches
        # ... and no other kernel: a step's total stays at len(STEP).
        assert sum(launches.values()) == TRAIN_STEPS * len(STEP), launches

        # The backward kernels against their plain versions on view 0's own
        # intermediates, as the step handed them over.
        (table, ts, te, grid_x, dC, dD, dT, C, D, T_fin), kw = \
            store["composite_bwd"]
        assert kw.get("tiles") is None
        k3_args = (table, ts, te, grid_x, dC, dD, dT, C, D, T_fin)
        n_eval_fwd = r.composite_fwd(table, ts, te, grid_x)[3]
        d_full, n_eval = r.composite_bwd(*k3_args)
        t.cuda.synchronize()
        k3_eval_differ = int((n_eval != n_eval_fwd).sum())
        assert k3_eval_differ == 0, \
            f"K3 evaluated pairs differ from K2's on {k3_eval_differ} pixels"
        (d_table, perm), _ = store["sort_back_rows"]
        assert bits_equal(t, d_table, d_full), "K3 is not deterministic"
        k3 = self.check_k3_tiles(k3_args, d_full, self.sample_tiles(ts, te))

        # K5b's rows, and the key K4 read (the id sort's values) against
        # the key gathered through K5b's permutation.
        (_, gid_sorted, num_valid, n), _ = store["pair_grads_to_gaussians"]
        v = perm.shape[0]
        key = t.where(t.arange(v, device=self.dev) < num_valid, gid_sorted,
                      n).to(t.int32)
        d_sorted = b.sort_back_rows(d_table, perm)
        want5 = b.gather_rows_plain(d_table, key, perm, v, v)
        assert bits_equal(t, d_sorted, want5[0]), "K5b rows differ"
        (ds, ks, num_valid, n), _ = store["segment_reduce"]
        assert bits_equal(t, ks, want5[1]), "K5b key: sort values differ"
        assert bits_equal(t, ds, d_sorted)
        k4 = self.check_k4(ds, ks, num_valid, n)
        errs = {"composite_bwd": k3.pop("k3_max_abs_err"),
                "gather_rows_bwd": float((d_sorted - want5[0]).abs().max()),
                "segment_reduce": k4["max_abs_err"]}

        # Times on the card (CUDA events), at the main path's shapes.
        ms = {
            "composite_bwd": cuda_ms(t, lambda: r.composite_bwd(*k3_args)),
            "gather_rows_bwd": cuda_ms(t, lambda: b.sort_back_rows(
                d_table, perm)),
            "segment_reduce": k4["ms"],
        }
        plain_ms = {
            "composite_bwd": cuda_ms(t, lambda: r.composite_bwd_plain(
                *k3_args), reps=1, warmup=False),
            "gather_rows_bwd": cuda_ms(t, lambda: b.sort_back_rows_plain(
                d_table, perm), reps=3),
            "segment_reduce": k4["plain_ms"],
        }
        library_ms = {
            "composite_bwd": None,
            "gather_rows_bwd": cuda_ms(t, lambda: d_table.index_select(
                1, perm)),
            "segment_reduce": k4["library_ms"],
        }

        # Least time for each kernel's work on this run's data.
        n_tiles, length = ts.shape[0], table.shape[1]
        nv = min(int(num_valid), v)
        n_evals = int(n_eval.sum())
        n_used = int(self.used_evaluations(table, ts, te, grid_x).sum())
        work = {
            "composite_bwd": (40 * nv + 40 * length + 8 * n_tiles
                              + 44 * 256 * n_tiles,
                              K2_OPS_PER_EVAL * n_evals
                              + K3_OPS_PER_USED * n_used),
            "gather_rows_bwd": (88 * v, 0),
        }
        bound_ms, bound_by = {}, {}
        for name, (nbytes, ops) in work.items():
            bound_ms[name], bound_by[name] = bound(nbytes, ops)
        bound_ms["segment_reduce"] = k4["bound_ms"]
        bound_by["segment_reduce"] = k4["bound_by"]
        # K5b on a source that stays in L2 (2^18 columns, ~11 MB in all)
        # through a random permutation: how near its byte bound a gather
        # comes when no sector has to come from device memory, and whether
        # the order of the rows still matters there. These calls are as
        # short as their host time: queued, and also paced by the host.
        small = min(1 << 18, v)
        d_small = d_table[:, :small + b.COMPOSITE_PAD].contiguous()
        p_small = t.randperm(small, device=self.dev, generator=t.Generator(
            device=self.dev).manual_seed(0))

        def k5b_small():
            return b.sort_back_rows(d_small, p_small)

        def library_small():
            return d_small.index_select(1, p_small)
        gather = dict(
            ms=ms["gather_rows_bwd"],
            library_ms=library_ms["gather_rows_bwd"],
            plain_ms=plain_ms["gather_rows_bwd"],
            bound_ms=bound_ms["gather_rows_bwd"],
            rows_per_pass_ms=self.gather_orders(
                lambda: b.sort_back_rows(d_table, perm)),
            l2_resident=dict(
                columns=small,
                ms=cuda_ms(t, k5b_small, queued=True),
                rows_per_pass_ms=self.gather_orders(k5b_small, queued=True),
                library_ms=cuda_ms(t, library_small, queued=True),
                host_paced_ms=cuda_ms(t, k5b_small),
                host_paced_library_ms=cuda_ms(t, library_small),
                bound_ms=bound(88 * small, 0)[0]))

        # fwd+bwd with bench.py's loss, and the whole train step.
        def fwd_bwd(cam):
            leaves = {name: getattr(state.params, name).detach()
                      .requires_grad_(True) for name in
                      self.interop.PARAM_FIELDS}
            out = self.render.render(
                cam, state.replace(params=state.params.replace(**leaves)),
                bg, antialiasing=True, backend="kernels", pair_capacity=p_cap,
                valid_capacity=v_cap)
            loss = (((out["render"] - cam.image) ** 2).mean()
                    + 0.01 * out["invdepth"].mean())
            return t.autograd.grad(loss, list(leaves.values()),
                                   allow_unused=True)

        def host_ms(fn, rounds=2):
            fn(cams[0])
            t.cuda.synchronize()
            t.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(rounds):
                for cam in cams:
                    fn(cam)
            t.cuda.synchronize()
            return ((time.perf_counter() - t0) * 1e3 / (rounds * len(cams)),
                    t.cuda.max_memory_allocated() / 2 ** 30)

        fwd_bwd_ms, fwd_bwd_gib = host_ms(fwd_bwd)
        chain = {"state": state, "opt": opt, "it": TRAIN_STEPS}

        def train_step(cam):
            chain["it"] += 1
            chain["state"], chain["opt"], _ = fns.step(
                chain["state"], chain["opt"], cam, chain["it"], None, bg)
        step_ms, step_gib = host_ms(train_step)

        self.results.update(launches=launches)
        for key_, val in (("errs", errs), ("ms", ms), ("plain_ms", plain_ms),
                          ("library_ms", library_ms),
                          ("bound_ms", bound_ms), ("bound_by", bound_by)):
            self.results[key_].update(val)
        emit("train", ok=True, n=FULL_N, width=FULL_W, height=FULL_H,
             views=len(cams), steps=TRAIN_STEPS, p_cap=p_cap, v_cap=v_cap,
             per_step=steps, launches=launches,
             **k3,
             k3_eval_differ_k2=k3_eval_differ,
             k3_pixels=int(n_eval.numel()), n_evals=n_evals, n_used=n_used,
             walk=self.walk_stats(table, ts, te, grid_x, n_used),
             max_abs_err=errs, ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
             gather=gather, k4=k4,
             k4_ids_per_block=b.segment_ids_per_block(n, v),
             fwd_bwd_ms=fwd_bwd_ms,
             fwd_bwd_mray_per_s=FULL_W * FULL_H / fwd_bwd_ms / 1e3,
             fwd_bwd_peak_mem_gib=fwd_bwd_gib, train_step_ms=step_ms,
             train_step_peak_mem_gib=step_gib)
        self.phase_profile(
            lambda cam: fns.step(state, opt, cam, 1, None, bg), cams,
            "train_profile")

    def phase_train_mid(self):
        """The mid scene: gradients from the kernels against those from the
        plain versions, then steps around a densify round and a reset."""
        t, T, k = self.torch, self.testing, self.kernels
        from priordepth_gaussiansplatting_torch.models import gaussians
        wh = MID_WH
        state = gaussians.grow_capacity(
            self.state(T.random_gaussians(1, MID_N)), 2 * MID_N)
        cams = self.train_cameras([(0.0, 0.0, -2.5), (0.2, -0.1, -2.4)], wh,
                                  wh, seed=2)
        p_cap, v_cap = self.view_capacities(state, cams)
        fns = self.train_fns(p_cap, v_cap)
        opt = self.optim.init_adam(state.params)
        bg = t.zeros(3, device=self.dev)

        runs, store = {}, {}
        for label in ("kernels", "plain"):
            with self.plain_kernels() if label == "plain" \
                    else self.recording(store):
                before = sum(k.launch_counts().values())
                runs[label] = fns.step(state, opt, cams[0], 1, None, bg)
                t.cuda.synchronize()
                runs[label] += (sum(k.launch_counts().values()) - before,)
        assert runs["kernels"][3] == len(STEP) and runs["plain"][3] == 0
        loss_k, loss_p = (float(runs[x][2]["loss"]) for x in runs)
        assert abs(loss_k - loss_p) <= 1e-5, (loss_k, loss_p)
        grad_err = {}
        pairs = [(n, getattr(runs["kernels"][1].mu, n),
                  getattr(runs["plain"][1].mu, n))
                 for n in self.interop.PARAM_FIELDS]
        pairs.append(("screen_grad_norm",
                      runs["kernels"][0].xyz_gradient_accum,
                      runs["plain"][0].xyz_gradient_accum))
        for n, got, want in pairs:
            scale = float(want.abs().max())
            diff = (got - want).abs()
            ok = diff <= GRAD_ATOL * scale + GRAD_RTOL * want.abs()
            grad_err[n] = {"max_abs": float(diff.max()), "max_ref": scale,
                           "within": float(ok.float().mean())}
            assert bool(ok.all()), (n, grad_err[n])
        # K4 on the mid scene's own pairs (~26 per active Gaussian).
        (ds, ks, num_valid, n), _ = store["segment_reduce"]
        k4 = self.check_k4(ds, ks, num_valid, n)

        state, opt, _, _ = runs["kernels"]
        # Without trained exposures the exposure group has no gradient.
        per_gaussian = self.optim.PER_GAUSSIAN
        steps = []
        for it in (2, 3):
            state, opt, m = self.checked_step(fns, state, opt,
                                              cams[it % 2], it, bg, "mid",
                                              groups=per_gaussian)
            steps.append(m)
        # The threshold that densifies a tenth of the Gaussians whose screen
        # gradient is not zero (most of this dense scene is occluded).
        mean_grad = state.xyz_gradient_accum / t.clamp_min(state.denom, 1.0)
        threshold = float(t.quantile(mean_grad[mean_grad > 0], 0.9))
        dens_vs_cpu = self.densify_against_cpu(state, opt, threshold)
        n_before = int(state.num_active)
        state, opt, info = self.densify.densify_and_prune(
            state, opt, threshold, 0.005, state.spatial_lr_scale, 0.0,
            generator=t.Generator(device=self.dev).manual_seed(0))
        info = {key: int(val) for key, val in info.items()}
        assert info["n_cloned"] + info["n_split"] > 0, info
        assert info["n_active"] == int(state.num_active) == (
            n_before + info["n_cloned"] + info["n_split"]
            - info["n_pruned"]), (n_before, info)
        state, opt = self.densify.reset_opacity(state, opt)
        p_cap2, v_cap2 = self.view_capacities(state, cams)
        fns = self.train_fns(p_cap2, v_cap2)
        for it in (4, 5):
            state, opt, m = self.checked_step(fns, state, opt,
                                              cams[it % 2], it, bg, "mid",
                                              groups=per_gaussian)
            assert int(m["n_active"]) == info["n_active"]
            steps.append(m)
        emit("train_mid", ok=True, n=MID_N, capacity=state.capacity,
             width=wh, height=wh, p_cap=[p_cap, p_cap2],
             v_cap=[v_cap, v_cap2], loss_kernels=loss_k, loss_plain=loss_p,
             grad_kernels_vs_plain=grad_err, k4=k4,
             densify_threshold=threshold,
             n_active_before=n_before, densify=info,
             densify_card_vs_cpu=dens_vs_cpu,
             steps=[{key: s[key] for key in ("loss", "n_active", "num_pairs",
                                             "skipped")} for s in steps])

    def densify_against_cpu(self, state, opt, threshold: float) -> dict:
        """One densify round (size prune on) on the card and on a CPU copy
        of the state, with the same split draws: the same counts and rows,
        parameters and moments within 1e-5. Returns the largest
        differences."""
        t, I = self.torch, self.interop
        args = (threshold, 0.005, state.spatial_lr_scale, 20.0)
        noise = t.randn((2, state.capacity, 3),
                        generator=t.Generator().manual_seed(1))
        s_np, o_np = I.gaussian_state_to_numpy(state), \
            I.adam_state_to_numpy(opt)
        cpu_s = I.gaussian_state_from_numpy(
            {k: s_np[k] for k in I.PARAM_FIELDS}, s_np["active"],
            state.active_sh_degree, state.max_sh_degree, device="cpu",
            spatial_lr_scale=state.spatial_lr_scale,
            **{k: s_np[k] for k in I.STAT_FIELDS})
        cpu_o = I.adam_state_from_numpy(o_np["mu"], o_np["nu"],
                                        o_np["count"], device="cpu")
        got = self.densify.densify_and_prune(state, opt, *args,
                                             noise=noise.to(self.dev))
        want = self.densify.densify_and_prune(cpu_s, cpu_o, *args,
                                              noise=noise)
        info = {k: int(v) for k, v in got[2].items()}
        assert info == {k: int(v) for k, v in want[2].items()}, info
        assert info["n_cloned"] + info["n_split"] > 0, info
        assert bool(t.equal(got[0].active.cpu(), want[0].active))
        diff = {}
        for part, g, w in (("params", got[0].params, want[0].params),
                           ("mu", got[1].mu, want[1].mu),
                           ("nu", got[1].nu, want[1].nu)):
            for k in I.PARAM_FIELDS:
                d = float((getattr(g, k).cpu() - getattr(w, k)).abs().max())
                assert d <= 1e-5, (part, k, d)
                diff[f"{part}.{k}"] = d
        return dict(info, max_abs_diff=max(diff.values()))

    def k6_within(self, table, grid_x, ids, start, end, cts, fwd=None):
        """K6 against its plain version on one slice of slots: forward by
        K2's rule, backward by K3's on the slots' columns, nothing written
        outside them. Returns the largest forward and backward errors."""
        t, r = self.torch, self.rasterize
        got = r.composite_fwd_bands(table, start, end, grid_x, ids)
        want = fwd or r.composite_fwd_bands_plain(table, start, end, grid_x,
                                                  ids)
        t.cuda.synchronize()
        err_f = 0.0
        for g, w in zip(got[:3], want[:3]):
            diff = (g - w).abs()
            err_f = max(err_f, float(diff.max()))
            assert float((diff <= 2e-5).float().mean()) >= 0.999
            assert float(diff.max()) <= 5e-3, float(diff.max())
        assert float((got[3] == want[3]).float().mean()) >= 0.999
        args = (table, start, end, grid_x, ids, cts[0], cts[1][0], cts[2][0],
                *got[:3])
        d_got, e_got = r.composite_bwd_bands(*args)
        d_want, e_want = r.composite_bwd_bands_plain(*args)
        t.cuda.synchronize()
        cols = t.cat([t.arange(s, e, device=self.dev) for s, e in
                      zip(start.tolist(), end.tolist())])
        a, w = d_got[:, cols], d_want[:, cols]
        within = ((a - w).abs() <= GRAD_ATOL * w.abs().amax(1, keepdim=True)
                  + GRAD_RTOL * w.abs()).float().mean(1)
        assert float(within.min()) >= 0.999, f"K6 rows: {within.tolist()}"
        assert float((e_got == e_want).float().mean()) >= 0.999
        outside = d_got.clone()
        outside[:, cols] = 0.0
        assert float(outside.abs().max()) == 0.0, "K6 wrote outside its band"
        err_b = float((a - w).abs().max()) if cols.numel() else 0.0
        return err_f, err_b

    def phase_bands(self):
        """K6 on view 0 of the full scene, band by band, against K2 and K3
        on the whole frame and against its plain version."""
        t, k, b, r = self.torch, self.kernels, self.binning, self.rasterize
        f = self.full
        w, h = FULL_W, FULL_H
        with t.no_grad():
            table, aux = b.bin_sorted_pairs(self.project(f["cams"][0],
                                                         f["state"]),
                                            w, h, f["p_cap"], f["v_cap"])
        ts, te = aux["tile_start"], aux["tile_end"]
        grid_x, _ = b.grid_shape(w, h)
        nt = int(ts.shape[0])
        gen = t.Generator(device=self.dev).manual_seed(0)
        cts = [t.randn(c, nt, r.PIX, generator=gen, device=self.dev)
               for c in (3, 1, 1)]
        whole = r.composite_fwd(table, ts, te, grid_x)
        d_whole, _ = r.composite_bwd(table, ts, te, grid_x, cts[0],
                                     cts[1][0], cts[2][0], *whole[:3])

        def band_cts(ids, n, m):
            """The frame's cotangents at the band's slots, 0 at pads."""
            real = (t.arange(ids.shape[0], device=self.dev)
                    + m * ids.shape[0]) < nt
            return [c[:, ids.long()] * real[None, :, None] for c in cts]

        # The main path: every count at 0 just before, read just after.
        t.cuda.synchronize()
        k.reset_launch_counts()
        runs = {}
        for n in BAND_COUNTS:
            runs[n] = []
            for m in range(n):
                ids, start, end = r.band_slots(ts, te, n, m)
                tab = table.detach().requires_grad_(True)
                outs = r.composite_bands(tab, ids, start, end, w, h)
                loss = sum((o * c).sum() for o, c in
                           zip(outs, band_cts(ids, n, m)))
                d_tab = t.autograd.grad(loss, tab)[0]
                runs[n].append(([o.detach() for o in outs], d_tab,
                                (ids, start, end)))
        t.cuda.synchronize()
        launches = k.launch_counts()
        total = sum(BAND_COUNTS)
        assert all(launches[x] == total for x in BANDS), launches
        assert all(launches[x] == 0 for x in STEP), launches

        # Bands against the frame: K2's outputs and K3's table exactly.
        for n, bands in runs.items():
            for kk, want in enumerate((whole[0], whole[1][None],
                                       whole[2][None])):
                got = t.cat([o[kk] for o, _, _ in bands], 1)[:, :nt]
                assert bits_equal(t, got, want), (n, kk)
            d_sum = None
            for m, (_, d_tab, (ids, start, end)) in enumerate(bands):
                lo, hi = int(start[0]), int(te[min((m + 1) * ids.shape[0],
                                                   nt) - 1])
                outside = d_tab.clone()
                outside[:, lo:hi] = 0.0
                assert float(outside.abs().max()) == 0.0, (n, m)
                d_sum = d_tab if d_sum is None else d_sum + d_tab
            assert bool(t.equal(d_sum, d_whole)), f"{n} bands differ from K3"
        assert float(d_whole.abs().max()) > 0

        # Against the plain version: the 8 busiest slots of band 0 of 3,
        # the last 8 slots of band 2 of 3 (pads among them), band 0 of 4.
        ids, start, end = r.band_slots(ts, te, 3, 0)
        top = t.argsort(end - start, descending=True, stable=True)[:8]
        ids2, start2, end2 = r.band_slots(ts, te, 3, 2)
        slices = {"busiest8": (ids[top], start[top], end[top], 3, 0),
                  "last8": (ids2[-8:], start2[-8:], end2[-8:], 3, 2)}
        errs = {}
        for name, (i, s_, e_, n, m) in slices.items():
            sl_cts = [c[:, i.long()] * (e_ > s_)[None, :, None]
                      for c in cts]
            errs[name] = self.k6_within(table, grid_x, i.contiguous(),
                                        s_.contiguous(), e_.contiguous(),
                                        sl_cts)
        assert int((ids2[-8:] == 0).sum()) >= 1, "no pad slot checked"
        ids0, s0, e0 = r.band_slots(ts, te, 4, 0)
        c0 = band_cts(ids0, 4, 0)
        plain = {}

        def plain_fwd():
            plain["fwd"] = r.composite_fwd_bands_plain(table, s0, e0, grid_x,
                                                       ids0)
        plain_ms = {"composite_fwd_bands": cuda_ms(t, plain_fwd, reps=1,
                                                   warmup=False)}
        fwd0 = r.composite_fwd_bands(table, s0, e0, grid_x, ids0)
        args0 = (table, s0, e0, grid_x, ids0, c0[0], c0[1][0], c0[2][0],
                 *fwd0[:3])
        plain_ms["composite_bwd_bands"] = cuda_ms(
            t, lambda: r.composite_bwd_bands_plain(*args0), reps=1,
            warmup=False)
        errs["band0_of_4"] = self.k6_within(table, grid_x, ids0, s0, e0, c0,
                                            fwd=plain["fwd"])
        self.results["errs"].update(
            composite_fwd_bands=max(e[0] for e in errs.values()),
            composite_bwd_bands=max(e[1] for e in errs.values()))

        # Times per band (CUDA events) and each band's least time.
        used = self.used_evaluations(table, ts, te, grid_x)
        length = table.shape[1]
        per_band = {}
        for n in BAND_COUNTS:
            rows = []
            for m in range(n):
                i, s_, e_ = r.band_slots(ts, te, n, m)
                c_ = band_cts(i, n, m)
                fw = r.composite_fwd_bands(table, s_, e_, grid_x, i)
                a_ = (table, s_, e_, grid_x, i, c_[0], c_[1][0], c_[2][0],
                      *fw[:3])
                slots = int(i.shape[0])
                pairs = int((e_ - s_).sum())
                evals = int(fw[3].sum())
                n_used = int(used[i.long()][e_ > s_].sum())
                fb = bound(40 * pairs + 12 * slots + 24 * 256 * slots,
                           K2_OPS_PER_EVAL * evals)
                bb = bound(40 * pairs + 40 * length + 12 * slots
                           + 44 * 256 * slots,
                           K2_OPS_PER_EVAL * evals + K3_OPS_PER_USED * n_used)
                rows.append(dict(
                    band=m, slots=slots, pads=max((m + 1) * slots - nt, 0),
                    pairs=pairs, evals=evals, used=n_used,
                    fwd_ms=cuda_ms(t, lambda: r.composite_fwd_bands(
                        table, s_, e_, grid_x, i)),
                    bwd_ms=cuda_ms(t, lambda: r.composite_bwd_bands(*a_)),
                    fwd_bound_ms=fb[0], fwd_bound_by=fb[1],
                    bwd_bound_ms=bb[0], bwd_bound_by=bb[1]))
            per_band[n] = rows
        frame = {"K2": cuda_ms(t, lambda: r.composite_fwd(table, ts, te,
                                                          grid_x)),
                 "K3": cuda_ms(t, lambda: r.composite_bwd(
                     table, ts, te, grid_x, cts[0], cts[1][0], cts[2][0],
                     *whole[:3]))}
        for n, rows in per_band.items():
            frame[f"K6_fwd_{n}_bands"] = sum(x["fwd_ms"] for x in rows)
            frame[f"K6_bwd_{n}_bands"] = sum(x["bwd_ms"] for x in rows)
        first = per_band[BAND_COUNTS[0]][0]
        for x, key in (("composite_fwd_bands", "fwd"),
                       ("composite_bwd_bands", "bwd")):
            self.results["launches"][x] = launches[x]
            self.results["ms"][x] = first[f"{key}_ms"]
            self.results["bound_ms"][x] = first[f"{key}_bound_ms"]
            self.results["bound_by"][x] = first[f"{key}_bound_by"]
            self.results["plain_ms"][x] = plain_ms[x]
            self.results["library_ms"][x] = None
        del self.full
        emit("bands", ok=True, n=FULL_N, width=w, height=h, tiles=nt,
             bands=list(BAND_COUNTS), launches={x: launches[x] for x in
                                                BANDS + STEP},
             max_abs_err={name: list(e) for name, e in errs.items()},
             per_band={str(n): rows for n, rows in per_band.items()},
             ms_per_frame=frame, plain_ms_band0_of_4=plain_ms)

    def phase_sharded(self):
        """The sharded step in a one-rank NCCL group on the card."""
        import torch.distributed as dist
        from priordepth_gaussiansplatting_torch.models import gaussians
        from priordepth_gaussiansplatting_torch.parallel import integrate
        from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
        from priordepth_gaussiansplatting_torch.parallel import step as pstep
        t, T, k, cfg = self.torch, self.testing, self.kernels, self.config
        with tempfile.TemporaryDirectory() as tmp:
            assert pmesh.initialize_multihost(
                f"file://{tmp}/store", world_size=1, rank=0, device=self.dev)
            try:
                mesh = pmesh.Mesh(1, 1, device=self.dev)
                assert mesh.backend == dist.get_backend() == \
                    pmesh.backend_for(self.dev)
                assert self.dev.type != "cuda" or mesh.backend == "nccl"
                out = self.sharded_runs(mesh, integrate, pstep, gaussians)
            finally:
                dist.destroy_process_group()
        emit("sharded", ok=True, backend=mesh.backend, world=1, **out)

    def sharded_runs(self, mesh, integrate, pstep, gaussians):
        t, T, k, cfg = self.torch, self.testing, self.kernels, self.config
        opt_cfg = cfg.OptimizationConfig(depth_feedback=True)
        pipe_cfg = cfg.PipelineConfig(antialiasing=True, backend="kernels")
        g = T.random_gaussians(0, FULL_N, extent=1.0,
                               scale_range=(0.001, 0.004))
        state0 = self.state(g, num_images=len(FULL_EYES))
        cams = self.train_cameras(FULL_EYES, FULL_W, FULL_H, seed=1)
        batches = [pstep.stack_cameras([c]) for c in cams]
        p_cap, _ = self.view_capacities(state0, cams, headroom=1.25)
        fns = integrate.make_sharded_fns(opt_cfg, pipe_cfg, mesh,
                                         use_trained_exp=True,
                                         pair_capacity=p_cap)
        single = self.step.make_train_step(opt_cfg, pipe_cfg,
                                           use_trained_exp=True,
                                           pair_capacity=p_cap)
        bg = t.zeros(3, device=self.dev)

        # 3 steps of each from the same state on the same views.
        s1, o1 = integrate.place_sharded(
            state0, self.optim.init_adam(state0.params), mesh)
        s2, o2 = state0, self.optim.init_adam(state0.params)
        loss_diff = []
        for it in (1, 2, 3):
            s1, o1, m1 = fns.step(s1, o1, batches[it - 1], it, None, bg)
            s2, o2, m2 = single.step(s2, o2, cams[it - 1], it, None, bg)
            loss_diff.append(abs(float(m1["loss"]) - float(m2["loss"])))
            assert int(m1["skipped"]) == 0 == int(m2["skipped"])
        assert max(loss_diff) <= 1e-5, loss_diff
        vs_single = {}
        pairs = [(f"mu.{n}", getattr(o1.mu, n), getattr(o2.mu, n))
                 for n in self.interop.PARAM_FIELDS]
        pairs += [("xyz", s1.params.xyz, s2.params.xyz),
                  ("xyz_gradient_accum", s1.xyz_gradient_accum,
                   s2.xyz_gradient_accum)]
        for n, got, want in pairs:
            diff = (got - want).abs()
            ok = diff <= GRAD_ATOL * float(want.abs().max()) \
                + GRAD_RTOL * want.abs()
            vs_single[n] = {"max_abs": float(diff.max()),
                            "within": float(ok.float().mean())}
            assert bool(ok.all()), (n, vs_single[n])
        del s1, o1, s2, o2

        # The main path: every count at 0 just before, read just after.
        state, opt = integrate.place_sharded(
            state0, self.optim.init_adam(state0.params), mesh)
        t.cuda.synchronize()
        k.reset_launch_counts()
        steps = []
        for i in range(TRAIN_STEPS):
            state, opt, m = self.checked_step(fns, state, opt,
                                              batches[i % len(cams)], i + 1,
                                              bg, "sharded")
            steps.append({key: m[key] for key in ("loss", "l1", "num_pairs",
                                                  "n_active")})
        launches = k.launch_counts()
        assert all(launches[n] == TRAIN_STEPS for n in STEP), launches
        assert all(launches[n] == 0 for n in BANDS), launches

        def host_ms(fn):
            """ms per step over the three views (after one warm-up step)
            and the peak memory."""
            fn(0)
            t.cuda.synchronize()
            t.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i in range(len(cams)):
                fn(i)
            t.cuda.synchronize()
            return ((time.perf_counter() - t0) * 1e3 / len(cams),
                    t.cuda.max_memory_allocated() / 2 ** 30)

        # The two steps in turns (sharded, single, single, sharded).
        step_fns = {
            "sharded": lambda i: fns.step(state, opt, batches[i], 11, None,
                                          bg),
            "single": lambda i: single.step(state, opt, cams[i], 11, None,
                                            bg)}
        step_ms = {"sharded": [], "single": []}
        step_gib = dict.fromkeys(step_ms, 0.0)
        for name in ("sharded", "single", "single", "sharded"):
            ms, gib = host_ms(step_fns[name])
            step_ms[name].append(ms)
            step_gib[name] = max(step_gib[name], gib)
        del state, opt, state0, step_fns

        # The mid scene: two steps, a sharded densify round, an opacity
        # reset and a step.
        wh = MID_WH
        mstate = gaussians.grow_capacity(
            self.state(T.random_gaussians(1, MID_N)), 2 * MID_N)
        mcams = self.train_cameras([(0.0, 0.0, -2.5), (0.2, -0.1, -2.4)], wh,
                                   wh, seed=2)
        mbatch = [pstep.stack_cameras([c]) for c in mcams]
        p2, _ = self.view_capacities(mstate, mcams)
        mfns = integrate.make_sharded_fns(opt_cfg, pipe_cfg, mesh,
                                          pair_capacity=p2)
        ms_, mo = integrate.place_sharded(
            mstate, self.optim.init_adam(mstate.params), mesh)
        per_gaussian = self.optim.PER_GAUSSIAN
        for it in (1, 2):
            ms_, mo, _ = self.checked_step(mfns, ms_, mo, mbatch[it % 2], it,
                                           bg, "sharded_mid",
                                           groups=per_gaussian)
        mean_grad = ms_.xyz_gradient_accum / t.clamp_min(ms_.denom, 1.0)
        threshold = float(t.quantile(mean_grad[mean_grad > 0], 0.9))
        dfns = integrate.make_sharded_fns(
            cfg.OptimizationConfig(depth_feedback=True,
                                   densify_grad_threshold=threshold),
            pipe_cfg, mesh, pair_capacity=p2)
        n_before = int(ms_.num_active)
        ms_, mo, info = dfns.densify(ms_, mo, seed=0)
        info = {key: int(v) for key, v in info.items()}
        assert info["n_cloned"] + info["n_split"] > 0, info
        assert info["n_active"] == int(ms_.num_active) == (
            n_before + info["n_cloned"] + info["n_split"]
            - info["n_pruned"]), (n_before, info)
        ms_, mo = dfns.reset_opacity(ms_, mo)
        p3, _ = self.view_capacities(ms_, mcams)
        mfns = integrate.make_sharded_fns(opt_cfg, pipe_cfg, mesh,
                                          pair_capacity=p3)
        ms_, mo, m = self.checked_step(mfns, ms_, mo, mbatch[1], 3, bg,
                                       "sharded_mid", groups=per_gaussian)
        assert int(m["n_active"]) == info["n_active"]
        return dict(n=FULL_N, width=FULL_W, height=FULL_H, views=len(cams),
                    steps=TRAIN_STEPS, p_cap=p_cap, per_step=steps,
                    launches={n: launches[n] for n in STEP + BANDS},
                    vs_single_3_steps=vs_single, loss_diff=loss_diff,
                    step_ms_in_turns=step_ms, step_peak_mem_gib=step_gib,
                    mid=dict(n=MID_N, capacity=ms_.capacity,
                             densify_threshold=threshold,
                             n_active_before=n_before, densify=info,
                             step_after_reset={key: m[key] for key in
                                               ("loss", "n_active",
                                                "num_pairs", "skipped")}))

    def multi_runs(self, world: int) -> dict:
        """This rank's part of ``--ranks``: for each rank grid (n_data,
        n_gauss, tile bands) over the world's process group, one sharded
        step from the full scene against single-rank steps on this rank's
        card (the mean over the batch's views of their gradients, this
        rank's rows), then 10 checked steps with their launches, and the
        time per step."""
        import torch.distributed as dist
        from priordepth_gaussiansplatting_torch.parallel import integrate
        from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
        from priordepth_gaussiansplatting_torch.parallel import step as pstep
        t, T, k, cfg = self.torch, self.testing, self.kernels, self.config
        opt_cfg = cfg.OptimizationConfig(depth_feedback=True)
        pipe_cfg = cfg.PipelineConfig(antialiasing=True, backend="kernels")
        g = T.random_gaussians(0, FULL_N, extent=1.0,
                               scale_range=(0.001, 0.004))
        state0 = self.state(g, num_images=len(MULTI_EYES))
        cams = self.train_cameras(MULTI_EYES, FULL_W, FULL_H, seed=1)
        p_cap, _ = self.view_capacities(state0, cams, headroom=1.25)
        single = self.step.make_train_step(opt_cfg, pipe_cfg,
                                           use_trained_exp=True,
                                           pair_capacity=p_cap)
        bg = t.zeros(3, device=self.dev)
        refs = []
        for cam in cams:
            _, o, m = single.step(state0, self.optim.init_adam(
                state0.params), cam, 1, None, bg)
            refs.append((o.mu, float(m["loss"])))
        t.cuda.synchronize()

        def timed(fn, n_steps):
            """ms per step on this rank's host clock, all ranks in step."""
            dist.barrier()
            t.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n_steps):
                fn(i)
            t.cuda.synchronize()
            dist.barrier()
            return (time.perf_counter() - t0) * 1e3 / n_steps

        grids = [(1, world, True), (1, world, False), (world, 1, False)]
        if world % 2 == 0 and world > 2:
            grids.append((2, world // 2, True))
        out = {"world": world, "p_cap": p_cap, "grids": {}}
        sc = {"s": state0, "o": self.optim.init_adam(state0.params)}

        def single_step(i):
            sc["s"], sc["o"], _ = single.step(sc["s"], sc["o"],
                                              cams[i % len(cams)], i + 1,
                                              None, bg)
        single_ms = [timed(single_step, 2 * len(cams))]
        for nd, ng, tile in grids:
            label = f"{nd}x{ng}{'_bands' if tile else ''}"
            t.cuda.reset_peak_memory_stats()
            mesh = pmesh.Mesh(nd, ng, device=self.dev)
            assert mesh.backend == pmesh.backend_for(self.dev)
            fns = integrate.make_sharded_fns(opt_cfg, pipe_cfg, mesh,
                                             use_trained_exp=True,
                                             tile_shard=tile,
                                             pair_capacity=p_cap)
            batches = [pstep.stack_cameras([cams[(i + d) % len(cams)]
                                            for d in range(nd)])
                       for i in range(len(cams))]
            s, o = integrate.place_sharded(
                state0, self.optim.init_adam(state0.params), mesh)
            s, o, m = fns.step(s, o, batches[0], 1, None, bg)
            loss_ref = float(np.mean([refs[d][1] for d in range(nd)]))
            assert abs(float(m["loss"]) - loss_ref) <= 1e-5, \
                (label, float(m["loss"]), loss_ref)
            local = s.capacity
            lo = mesh.gauss_rank * local
            errs = {}
            for n in self.interop.PARAM_FIELDS:
                want = sum(getattr(refs[d][0], n) for d in range(nd)) / nd
                if n in self.optim.PER_GAUSSIAN:
                    want = want[lo:lo + local]
                got = getattr(o.mu, n)
                diff = (got - want).abs()
                ok = diff <= GRAD_ATOL * float(want.abs().max()) \
                    + GRAD_RTOL * want.abs()
                errs[n] = float(diff.max())
                assert bool(ok.all()), (label, n, errs[n])
            # The main path: every count at 0 just before, read just after.
            t.cuda.synchronize()
            dist.barrier()
            k.reset_launch_counts()
            for i in range(TRAIN_STEPS):
                s, o, m = self.checked_step(
                    fns, s, o, batches[i % len(batches)], i + 2, bg, label,
                    path=TILE_STEP if tile and ng > 1 else STEP)
            launches = k.launch_counts()
            chain = {"s": s, "o": o}

            def step(i):
                chain["s"], chain["o"], _ = fns.step(
                    chain["s"], chain["o"], batches[i % len(batches)],
                    TRAIN_STEPS + 2 + i, None, bg)
            step_ms = timed(step, 2 * len(cams))
            # Where a step's time goes on this rank (NCCL kernels count
            # their waits for the other ranks as device time).
            prof = self.profile(step, list(range(len(cams))))
            out["grids"][label] = dict(
                n_data=nd, n_gauss=ng, tile_bands=tile, shard_rows=local,
                loss_step1=float(m["loss"]), grad_max_abs_err_step1=errs,
                launches={n: launches[n] for n in KERNELS if launches[n]},
                step_ms=step_ms, last_step={key: m[key] for key in
                                            ("loss", "num_pairs",
                                             "n_active", "skipped")},
                peak_mem_gib=t.cuda.max_memory_allocated() / 2 ** 30,
                profile={key: prof[key] for key in (
                    "traced_wall_ms_per_frame", "device_ms_per_frame",
                    "device_busy_share", "device_ops_per_frame")},
                device_top=prof["device_top"][:10])
            del s, o, chain, fns
        single_ms.append(timed(single_step, 2 * len(cams)))
        out["single_step_ms"] = single_ms
        return out

    def phase_cli(self):
        from priordepth_gaussiansplatting_torch.train import checkpoint
        from priordepth_gaussiansplatting_torch.utils import config
        with tempfile.TemporaryDirectory() as tmp:
            scene = os.path.join(tmp, "scene")
            model = os.path.join(tmp, "model")
            self.run_cmd([sys.executable, "-m", PORT + "make_synthetic_scene",
                          scene, "256", "4"], 600)
            g = self.testing.random_gaussians(3, 20_000, extent=0.8,
                                              scale_range=(0.01, 0.04))
            checkpoint.save_model_snapshot(model, 1000, self.state(g))
            config.save_cfg_args(model, config.ModelConfig(
                source_path=scene, model_path=model))
            t0 = time.perf_counter()
            self.run_cmd([sys.executable, "-m",
                          "priordepth_gaussiansplatting_torch.render", "-m",
                          model], 600)
            cli_s = time.perf_counter() - t0
            from PIL import Image
            rdir = os.path.join(model, "train", "ours_1000", "renders")
            pngs = sorted(os.listdir(rdir))
            assert len(pngs) == 4, pngs
            stds = [float(np.asarray(Image.open(os.path.join(rdir, p)),
                                     np.float32).std()) for p in pngs]
            assert min(stds) > 0, stds
        emit("cli", ok=True, renders=len(pngs), png_std=stds,
             cli_seconds=cli_s)

    def phase_bin(self):
        """K7 through bin_gaussians at full width, against its plain version
        and the plain pipeline; a rect 256 tiles wide against a direct
        enumeration."""
        t, T, k, b = self.torch, self.testing, self.kernels, self.binning
        g = T.random_gaussians(0, FULL_N, extent=1.0,
                               scale_range=(0.001, 0.004))
        state = self.state(g)
        cam = T.look_at_camera(FULL_EYES[0], width=FULL_W, height=FULL_H,
                               device=self.dev)
        with t.no_grad():
            proj = self.project(cam, state)
        grid_x, grid_y = b.grid_shape(FULL_W, FULL_H)
        num_tiles = grid_x * grid_y

        # The main path: every count at 0 just before, read just after.
        t.cuda.synchronize()
        k.reset_launch_counts()
        binned = b.bin_gaussians(proj, FULL_W, FULL_H, BIN_P)
        t.cuda.synchronize()
        launches = k.launch_counts()
        assert launches == {n: int(n == "expand_tiles") for n in launches}, \
            launches

        # K7 against its plain version on the path's inputs, bit for bit.
        x = b.tile_inputs(proj, FULL_W, FULL_H, BIN_P)
        args = (x["offsets"], x["base"], x["nx"], x["gid"], x["total"],
                BIN_P, grid_x, num_tiles)
        got = b.expand_tiles(*args)
        want = b.expand_tiles_plain(*args)
        t.cuda.synchronize()
        for name, a, w in zip(("tile", "gid", "hist"), got, want):
            assert bits_equal(t, a, w), f"K7 {name} differs"
        with self.plain_kernels():
            plain = b.bin_gaussians(proj, FULL_W, FULL_H, BIN_P)
        for f in ("depth_order", "gauss_ids", "tile_ids", "tile_start",
                  "tile_end", "num_pairs", "overflow"):
            assert bits_equal(t, getattr(binned, f), getattr(plain, f)), f
        num_pairs, overflow = int(binned.num_pairs), int(binned.overflow)
        assert num_pairs > 0 and int(binned.tile_end[-1]) == num_pairs

        # A rect 256 tiles wide: one large Gaussian before a 4096-pixel-wide
        # camera, among small ones (most of them above or below the view:
        # zero-count rects in front of the camera).
        wg = T.wide_gaussians(WIDE_N)
        wcam = T.look_at_camera(FULL_EYES[0], width=WIDE_W, height=WIDE_H,
                                device=self.dev)
        with t.no_grad():
            wproj = self.project(wcam, self.state(wg))
        _, nx, counts = b._rect_geometry(wproj, WIDE_W, WIDE_H, tight=False)
        assert int(nx.max()) >= 256, int(nx.max())
        slots = T.enumerate_slots(wproj, WIDE_W, WIDE_H)
        total = slots.shape[0]
        wp = 1024 * (total // 1024 + 1)
        wgx, wgy = b.grid_shape(WIDE_W, WIDE_H)
        wx = b.tile_inputs(wproj, WIDE_W, WIDE_H, wp)
        tile, gid, hist = b.expand_tiles(
            wx["offsets"], wx["base"], wx["nx"], wx["gid"], wx["total"], wp,
            wgx, wgx * wgy)
        wbin = b.bin_gaussians(wproj, WIDE_W, WIDE_H, wp)
        t.cuda.synchronize()
        assert np.array_equal(tile[:total].cpu().numpy(), slots[:, 0])
        assert np.array_equal(gid[:total].cpu().numpy(), slots[:, 1])
        want_t = slots[np.argsort(slots[:, 0], kind="stable")]
        counts_t = np.bincount(slots[:, 0], minlength=wgx * wgy)
        assert np.array_equal(hist.cpu().numpy(), counts_t)
        assert int(wbin.num_pairs) == total and int(wbin.overflow) == 0
        assert np.array_equal(wbin.tile_ids[:total].cpu().numpy(),
                              want_t[:, 0])
        assert np.array_equal(wbin.gauss_ids[:total].cpu().numpy(),
                              want_t[:, 1])
        assert np.array_equal((wbin.tile_end - wbin.tile_start).cpu().numpy(),
                              counts_t)

        # K7's owner windows: the blocks that search in device memory, on
        # both scenes, under K7's window and under K1's one-chunk window of
        # 256 slots; and a spill case on the card, bit for bit.
        windows = {}
        for scene, inp, cap, tiles in (("full", x, BIN_P, num_tiles),
                                       ("wide", wx, wp, wgx * wgy)):
            grid = b.expand_tiles_grid(cap, tiles)["grid"]
            for label, part in (("k7", (b.TILES_STEP, b.TILES_CHUNKS,
                                         grid)), ("k1_window", ())):
                spill = b.owner_window_plain(inp["offsets"], inp["total"],
                                             cap, *part)[2]
                windows[f"{scene}_{label}"] = [int(spill.sum()),
                                               int(spill.numel())]
        assert windows["full_k7"][0] == windows["wide_k7"][0] == 0, windows
        case = {a: v.to(self.dev) if isinstance(v, t.Tensor) else v
                for a, v in T.tile_window_cases()["spill"].items()}
        spill = b.owner_window_plain(
            case["offsets"], case["total"], case["p_cap"], b.TILES_STEP,
            b.TILES_CHUNKS,
            b.expand_tiles_grid(case["p_cap"], case["num_tiles"])["grid"])[2]
        windows["spill_case_k7"] = [int(spill.sum()), int(spill.numel())]
        assert windows["spill_case_k7"][0] > 0, windows
        for name, a, w in zip(("tile", "gid", "hist"), b.expand_tiles(**case),
                              b.expand_tiles_plain(**case)):
            assert bits_equal(t, a, w), f"K7 spill case: {name} differs"

        # Times (CUDA events) at the path's shapes, and the least time: the
        # slots' two int32 writes, the N rows' offset, base, width and id
        # reads, the histogram. Queued: K7 runs shorter than its wrapper's
        # host time (the unqueued time is the host's pace).
        n = FULL_N
        ms = cuda_ms(t, lambda: b.expand_tiles(*args), queued=True)
        unqueued_ms = cuda_ms(t, lambda: b.expand_tiles(*args))
        plain_ms = cuda_ms(t, lambda: b.expand_tiles_plain(*args), reps=3)
        bin_ms = cuda_ms(t, lambda: b.bin_gaussians(proj, FULL_W, FULL_H,
                                                     BIN_P))
        bound_ms, bound_by = bound(8 * BIN_P + 16 * n + 4 * num_tiles + 4, 0)
        self.results["errs"]["expand_tiles"] = 0.0
        self.results["ms"]["expand_tiles"] = ms
        self.results["plain_ms"]["expand_tiles"] = plain_ms
        self.results["library_ms"]["expand_tiles"] = None
        self.results["bound_ms"]["expand_tiles"] = bound_ms
        self.results["bound_by"]["expand_tiles"] = bound_by
        emit("bin", ok=True, n=n, width=FULL_W, height=FULL_H, p_cap=BIN_P,
             launches=launches, num_pairs=num_pairs, overflow=overflow,
             zero_count_rects=int((x["nx"] == 0).sum()),
             wide=dict(width=WIDE_W, height=WIDE_H, n=WIDE_N,
                       max_rect_tiles=int(nx.max()), pairs=total,
                       zero_count_rects=int((counts == 0).sum())),
             spilling_blocks=windows, ms=ms, unqueued_ms=unqueued_ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             bin_gaussians_ms=bin_ms)

    def phase_turns(self, other: str):
        """``--turns DIR``: K7 and K1 (``csrc/expand_pairs.cu``) of this
        checkout in turns with those built from DIR's ``csrc/`` (another
        checkout whose two entry points take the same arguments): other /
        this / this / other, on view 0 of the full scene (K7 at P = 2^22,
        K1 at the three views' capacity), each side's outputs against the
        plain versions, its registers and blocks per SM, and queued
        CUDA-event times (K7 also unqueued). This side's K7 is timed
        through its wrapper; the other's through the same launch with the
        histogram zeroed first, as its wrapper did (a memset launch)."""
        import pathlib
        t, T, b = self.torch, self.testing, self.binning
        from priordepth_gaussiansplatting_torch.kernels import build
        g = T.random_gaussians(0, FULL_N, extent=1.0,
                               scale_range=(0.001, 0.004))
        state = self.state(g)
        cams = [T.look_at_camera(e, width=FULL_W, height=FULL_H,
                                 device=self.dev) for e in FULL_EYES]
        p_cap, _ = self.view_capacities(state, cams)
        with t.no_grad():
            proj = self.project(cams[0], state)
        grid_x, grid_y = b.grid_shape(FULL_W, FULL_H)
        num_tiles = grid_x * grid_y
        x = b.tile_inputs(proj, FULL_W, FULL_H, BIN_P)
        k7 = (x["offsets"], x["base"], x["nx"], x["gid"], x["total"], BIN_P,
              grid_x, num_tiles)
        k1 = dict(b.depth_sorted_rects(proj, FULL_W, FULL_H), p_cap=p_cap,
                  grid_x=grid_x, num_tiles=num_tiles)
        want7 = b.expand_tiles_plain(*k7)
        want1 = b.expand_pairs_plain(**k1)
        sides = {"this": (build.CSRC, build.BUILD_DIR),
                 "other": (pathlib.Path(other).resolve()
                           / "priordepth_gaussiansplatting_torch" / "csrc",
                           build.BUILD_DIR.parent / "kernels_other")}

        def zeroed_k7(*args):
            """K7 with the histogram zeroed before the launch, as the
            wrapper did before K7 zeroed it itself (the other side's
            contract; this side's kernel writes every bin all the same)."""
            p_cap, num = args[5], args[7]
            out = [t.empty(p_cap, dtype=t.int32, device=self.dev)
                   for _ in range(2)]
            hist = t.zeros(num + num % 2 + 2, dtype=t.int32, device=self.dev)
            ptr, i32 = self.kernels.ptr, self.kernels.i32
            self.kernels.launch(
                "expand_pairs", [ptr] * 5 + [i32] * 4 + [ptr] * 3, *args[:5],
                args[0].shape[0], *args[5:], *out, hist,
                entry="expand_tiles")
            return out[0], out[1], hist[:num]
        rows = []
        for side in ("other", "this", "this", "other"):
            csrc, build_dir = sides[side]
            k7_call = b.expand_tiles if side == "this" else zeroed_k7
            with swapped([(build, "CSRC", csrc),
                          (build, "BUILD_DIR", build_dir)]):
                build._loaded.clear()
                got7 = k7_call(*k7)
                got1 = b.expand_pairs(**k1)
                t.cuda.synchronize()
                for name, a, w in zip(("tile", "gid", "hist"), got7, want7):
                    assert bits_equal(t, a, w), f"K7 ({side}) {name} differs"
                assert bits_equal(t, got1[1], want1[1]), f"K1 ({side}) ids"
                assert bits_equal(t, got1[2], want1[2]), f"K1 ({side}) rows"
                flips = int((got1[0] != want1[0]).sum())
                assert flips <= 1e-5 * int(k1["total"]), (side, flips)
                out = (ctypes.c_int * 3)()
                rc = build.entry("expand_pairs", "expand_pairs_occupancy",
                                 [ctypes.POINTER(ctypes.c_int)])(out)
                assert rc == 0, rc
                ptxas = [ln.split("ptxas info    :")[-1].strip()
                         for ln in build.ptxas_report(
                             "expand_pairs").splitlines() if "Used" in ln]
                lib = build.load("expand_pairs")
                if hasattr(lib, "expand_tiles_shape"):  # K7's persistent grid
                    shape = (ctypes.c_int * 4)()
                    rc = build.entry("expand_pairs", "expand_tiles_shape",
                                     [ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)])(
                                          BIN_P, num_tiles, shape)
                    assert rc == 0, rc
                    out[1] = shape[0]
                rows.append(dict(
                    side=side,
                    expand_tiles_ms=cuda_ms(t, lambda: k7_call(*k7),
                                            queued=True),
                    expand_pairs_ms=cuda_ms(
                        t, lambda: b.expand_pairs(**k1), queued=True),
                    expand_tiles_unqueued_ms=cuda_ms(
                        t, lambda: k7_call(*k7)),
                    k1_cull_flips=flips,
                    blocks_per_sm={"expand_pairs": out[0],
                                   "expand_tiles": out[1]},
                    ptxas=ptxas))
            build._loaded.clear()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        self.smi = smi
        emit("turns", ok=True, other=other, nvidia_smi=smi, n=FULL_N,
             width=FULL_W, height=FULL_H, k7_p_cap=BIN_P, k1_p_cap=p_cap,
             pairs=int(x["total"]), turns=rows)

    def run_cmd(self, cmd, timeout: int, env=None) -> str:
        """Run `cmd` from the repo root (with `env` added to the
        environment); its stdout, or raise with the end of its output."""
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=REPO,
                                      **(env or {})),
                             timeout=timeout)
        if out.returncode != 0:
            raise RuntimeError(f"{cmd[:4]} exited {out.returncode}:\n"
                               f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        return out.stdout

    def phase_probe(self):
        """The stage probe at full width, as a user runs it."""
        t0 = time.perf_counter()
        out = self.run_cmd([sys.executable, "-m",
                            "priordepth_gaussiansplatting_torch.perf_probe",
                            str(FULL_N), str(FULL_W), str(FULL_H)], 600)
        seconds = time.perf_counter() - t0
        res = json.loads(out.strip().splitlines()[-1])
        st = res["stages"]
        calls = st["bin+sort"]["calls"]
        assert st["project"]["launches"] == {}, st["project"]
        assert st["bin+sort"]["launches"] == {"expand_tiles": calls}, st
        assert st["full fwd"]["launches"] == dict.fromkeys(FORWARD, calls)
        assert st["full fwd+bwd"]["launches"] == dict.fromkeys(STEP, calls)
        assert res["pairs"] > 0 and res["device"].startswith("cuda")
        self.results["launches"]["expand_tiles"] = calls
        self.results["probe"] = res
        emit("probe", ok=True, seconds=seconds, n=res["n"],
             width=res["width"], height=res["height"],
             pair_capacity=res["pair_capacity"], pairs=res["pairs"],
             overflow=res["overflow"], iters=res["iters"],
             ms={name: v["ms"] for name, v in st.items()},
             launches={name: v["launches"] for name, v in st.items()},
             rays_per_s_fwd=res["rays_per_s_fwd"],
             rays_per_s_fwd_bwd=res["rays_per_s_fwd_bwd"])

    def train_cli(self, args, timeout: int = 900, path=STEP,
                  viewer: bool = False) -> dict:
        """One run of the train CLI (with `viewer` its network viewer on):
        its summary line, as JSON, and its output. Its steps must launch
        each kernel of `path` once."""
        out = self.run_cmd([sys.executable, "-m",
                            "priordepth_gaussiansplatting_torch.train",
                            "--eval"] + ([] if viewer else
                                         ["--disable_viewer"]) + [
                            "--noise_injection_iter", "0",
                            "--floating_prune_iter", "0",
                            "--init_capacity", str(CLI_CAPACITY),
                            "--pin_pair_capacity", str(CLI_PAIRS)] + args,
                           timeout)
        last = out.strip().splitlines()[-1]
        assert last.startswith("Training complete: "), last
        res = json.loads(last[len("Training complete: "):])
        assert res["skipped"] == 0, res
        assert res["step_launches"] == dict.fromkeys(
            path, res["iterations_run"]), res["step_launches"]
        assert "overflowed the pair capacity" not in out, out[-3000:]
        return dict(res, out=out)

    def phase_train_cli(self):
        """Train a raycast scene with the port's CLI, resume it from its
        checkpoint, render its snapshot."""
        size, views = CLI_SCENE
        scene = self.cli_scene = os.path.join(self.work, "cli_scene")
        t0 = time.perf_counter()
        self.run_cmd([sys.executable, "-m", PORT + "make_synthetic_scene",
                      scene, str(size), str(views)], 600)
        scene_s = time.perf_counter() - t0
        # The model stays for phase metrics.
        model = self.cli_model = os.path.join(self.work, "cli_model")
        with tempfile.TemporaryDirectory() as tmp:
            run = self.train_cli(
                ["-s", scene, "-m", model, "--iterations", str(CLI_ITERS),
                 "--test_iterations", str(CLI_CHECK), str(CLI_ITERS),
                 "--save_iterations", str(CLI_ITERS),
                 "--checkpoint_iterations", str(CLI_CHECK)])
            assert run["iterations_run"] == CLI_ITERS
            ev = read_events(model)
            psnr, train_psnr, steady = run_readings(ev, CLI_CHECK + 50,
                                                    CLI_ITERS - 50)
            assert psnr[CLI_ITERS] > psnr[CLI_CHECK], psnr
            self.results["train_cli"] = dict(
                it_per_s_between_evals=steady, test_psnr=psnr,
                losses={e["step"]: e["value"] for e in ev if e.get("tag")
                        == "train_loss_patches/total_loss"})
            resumed = self.train_cli(
                ["-s", scene, "-m", os.path.join(tmp, "resumed"),
                 "--iterations", str(CLI_CHECK + CLI_RESUME),
                 "--test_iterations", str(CLI_CHECK + CLI_RESUME),
                 "--save_iterations", str(CLI_CHECK + CLI_RESUME),
                 "--start_checkpoint",
                 os.path.join(model, f"chkpnt{CLI_CHECK}.pkl")])
            assert resumed["iterations_run"] == CLI_RESUME
            t0 = time.perf_counter()
            rendered = self.run_cmd([sys.executable, "-m",
                                     "priordepth_gaussiansplatting_torch."
                                     "render", "-m", model, "--skip_train"],
                                    600)
            render_s = time.perf_counter() - t0
            from PIL import Image
            rdir = os.path.join(model, "test", f"ours_{CLI_ITERS}", "renders")
            pngs = sorted(os.listdir(rdir))
            assert len(pngs) == -(-views // 8), pngs
            stds = [float(np.asarray(Image.open(os.path.join(rdir, p)),
                                     np.float32).std()) for p in pngs]
            assert min(stds) > 0, stds
        emit("train_cli", ok=True, scene=dict(size=size, views=views,
                                              seconds=scene_s),
             iterations=CLI_ITERS, wall_s=run["wall_s"],
             it_per_s=CLI_ITERS / run["wall_s"],
             it_per_s_between_evals=steady, n_active=run["n_active"],
             step_launches=run["step_launches"], skipped=run["skipped"],
             test_psnr=psnr, train_psnr=train_psnr,
             resumed=dict(iterations_run=resumed["iterations_run"],
                          skipped=resumed["skipped"],
                          wall_s=resumed["wall_s"]),
             renders=len(pngs), render_cli_s=render_s,
             render_cli_overflowed_views=rendered.count(
                 "overflowed the pair capacity"))

    def phase_mesh_train(self):
        """The trainer over a one-rank NCCL mesh on train_cli's scene and
        flags: CLI_ITERS iterations with their evaluations and a
        checkpoint, iteration by iteration against the single-rank trainer
        (both fed the same split draws; up to the first densify round that
        trainer is the train CLI's run), and a resume from the
        checkpoint."""
        import torch.distributed as dist
        from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
        from priordepth_gaussiansplatting_torch.train import __main__ as cli
        t, k = self.torch, self.kernels

        def trainer(model, iters, mesh=None):
            return cli.build_trainer(cli.parser().parse_args(
                ["-s", self.cli_scene, "-m", model, "--eval", "--quiet",
                 "--disable_viewer", "--noise_injection_iter", "0",
                 "--floating_prune_iter", "0",
                 "--init_capacity", str(CLI_CAPACITY),
                 "--pin_pair_capacity", str(CLI_PAIRS),
                 "--iterations", str(iters)]), self.dev, mesh)

        def same_draws(tr):
            """Split draws from one seed, so that the two trainers' densify
            rounds move the same rows the same way."""
            g = t.Generator(self.dev).manual_seed(0)
            tr.noise_source = lambda: t.randn(
                (2, tr.state.capacity, 3), generator=g, device=self.dev)
            return tr

        opt = self.config.OptimizationConfig()
        first_round = next((it for it in range(opt.densify_from_iter + 1,
                                               CLI_ITERS + 1)
                            if it % opt.densification_interval == 0),
                           CLI_ITERS)
        ref, losses = same_draws(trainer("", CLI_ITERS)), []
        ref.train(iterations=CLI_ITERS, test_iterations=(),
                  save_iterations=(),
                  on_iteration=lambda tr, it, m: losses.append(m["loss"]))
        ref_losses = t.stack(losses).double().cpu().numpy()
        del ref
        # Up to the first densify round the single-rank trainer in this
        # process is the train CLI's (its own draws start there).
        cli_losses = self.results["train_cli"]["losses"]
        cli_diff = max(abs(v - ref_losses[it - 1]) / abs(ref_losses[it - 1])
                       for it, v in cli_losses.items() if it <= first_round)

        with tempfile.TemporaryDirectory() as tmp:
            assert pmesh.initialize_multihost(
                f"file://{tmp}/store", world_size=1, rank=0, device=self.dev)
            try:
                mesh = pmesh.Mesh(1, 1, device=self.dev)
                model = os.path.join(tmp, "model")
                tr, losses = same_draws(trainer(model, CLI_ITERS, mesh)), []
                t.cuda.synchronize()
                k.reset_launch_counts()
                run = tr.train(
                    iterations=CLI_ITERS,
                    test_iterations=(CLI_CHECK, CLI_ITERS),
                    save_iterations=(), checkpoint_iterations=(CLI_CHECK,),
                    on_iteration=lambda tr_, it, m: losses.append(m["loss"]))
                launches = k.launch_counts()
                tr.logger.close()
                mesh_losses = t.stack(losses).double().cpu().numpy()
                del tr
                resumed = trainer(os.path.join(tmp, "resumed"),
                                  CLI_CHECK + CLI_RESUME, mesh)
                resumed.restore(os.path.join(model, f"chkpnt{CLI_CHECK}.pkl"))
                res2 = resumed.train(
                    iterations=CLI_CHECK + CLI_RESUME,
                    test_iterations=(CLI_CHECK + CLI_RESUME,),
                    save_iterations=())
                del resumed
                psnr, train_psnr, steady = run_readings(
                    read_events(model), CLI_CHECK + 50, CLI_ITERS - 50)
            finally:
                dist.destroy_process_group()
        rel = np.abs(mesh_losses - ref_losses) / np.abs(ref_losses)
        differ = np.nonzero(rel > 1e-5)[0]
        assert not len(differ), (
            f"the mesh trainer's loss first differs from the single-rank "
            f"trainer's at iteration {int(differ[0]) + 1}: "
            f"{mesh_losses[differ[0]]} vs {ref_losses[differ[0]]}")
        assert cli_diff <= 1e-5, cli_diff
        assert run["skipped"] == 0 and res2["skipped"] == 0, (run, res2)
        assert run["step_launches"] == dict.fromkeys(STEP, CLI_ITERS), run
        assert all(launches[n] >= CLI_ITERS for n in STEP), launches
        assert all(launches[n] == 0 for n in BANDS), launches
        assert res2["iterations_run"] == CLI_RESUME
        assert psnr[CLI_ITERS] > psnr[CLI_CHECK], psnr
        emit("mesh_train", ok=True, world=1, backend=mesh.backend,
             iterations=CLI_ITERS, wall_s=run["wall_s"],
             it_per_s_between_evals=steady,
             train_cli_it_per_s_between_evals=self.results["train_cli"][
                 "it_per_s_between_evals"],
             losses_vs_single=dict(iterations=CLI_ITERS,
                                   max_rel=float(rel.max()),
                                   equal_bits=int((rel == 0).sum())),
             first_densify_round=first_round,
             cli_losses_vs_single_max_rel=cli_diff,
             n_active=run["n_active"], step_launches=run["step_launches"],
             launches={n: launches[n] for n in STEP}, test_psnr=psnr,
             train_psnr=train_psnr,
             train_cli_test_psnr=self.results["train_cli"]["test_psnr"],
             resumed=dict(iterations_run=res2["iterations_run"],
                          skipped=res2["skipped"], wall_s=res2["wall_s"]))

    # --- the thesis events and the evaluation CLI ---------------------------

    def prune_near(self, st, terms, extent: float):
        """(near_depth, near_edge) of one prune view: the valid rows whose
        rendered inverse depth lies within INVDEPTH_TOL of a value at which
        one of the floating tests flips (k = 1, b = 0), and the valid rows
        whose centre lies within EDGE_TOL_PX of a pixel edge (another
        device may read the next pixel)."""
        t = self.torch
        from priordepth_gaussiansplatting_torch.train import prune
        inv = terms.rend_invdepth
        inf = t.full_like(inv, float("inf"))
        geo = t.prod(st.get_scaling(), dim=1) ** (1.0 / 3.0)
        margin = inf
        for depth in (terms.mono_depth - extent, terms.cam_z - geo):
            flip = 1.0 / depth - prune.EPSILON
            margin = t.minimum(margin, t.where(depth > 0,
                                               (inv - flip).abs(), inf))
        edge = t.minimum((terms.px - t.round(terms.px)).abs(),
                         (terms.py - t.round(terms.py)).abs())
        return (terms.valid & (margin < INVDEPTH_TOL),
                terms.valid & (edge < EDGE_TOL_PX))

    def prune_run(self, ck: str, scene: str, device, plain: bool = False):
        """``prune_loop`` from checkpoint `ck` over `scene`'s training views
        and priors on `device`, rendered as the trainer renders them (the
        default pair capacity; on the card through the kernels, or with
        `plain` their plain versions), RandomState(THESIS_SEED). Returns
        its totals, final mask, the rows near a threshold in any of its
        views, launches and seconds."""
        t, k = self.torch, self.kernels
        from priordepth_gaussiansplatting_torch.data.dataset import Scene
        from priordepth_gaussiansplatting_torch.train import checkpoint, prune
        sc = Scene(scene, depths="depths", eval_split=True, device=device)
        state, opt, _ = checkpoint.load_checkpoint(ck, device=device)
        bg = t.zeros(3, device=device)
        near = [t.zeros(state.capacity, dtype=t.bool, device=device)] * 2
        overflow = []

        def rfn(cam, st):
            out = self.render.render(cam, st, bg, backend="kernels")
            overflow.append(int(out["overflow"]))
            terms = prune.view_terms(st, cam, out["invdepth"], out["radii"])
            d, e = self.prune_near(st, terms, sc.cameras_extent)
            near[0], near[1] = near[0] | d, near[1] | e
            return out["invdepth"], out["radii"]

        card = device.type == "cuda"
        if card:
            t.cuda.synchronize()
        k.reset_launch_counts()
        t0 = time.perf_counter()
        with (self.plain_kernels() if plain else contextlib.nullcontext()):
            state, opt, info = prune.prune_loop(
                state, opt, sc.train_cameras, rfn, sc.cameras_extent,
                rng=np.random.RandomState(THESIS_SEED))
        if card:
            t.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = k.launch_counts()
        assert not any(overflow), f"a prune view overflowed: {overflow}"
        return dict(info=info, active=state.active.cpu().numpy(),
                    near_depth=near[0].cpu().numpy(),
                    near_edge=near[1].cpu().numpy(), seconds=seconds,
                    launches={n: launches[n] for n in FORWARD},
                    n_active=int(state.num_active))

    @staticmethod
    def masks_agree(a: dict, b: dict) -> dict:
        """Two prune results' masks must agree except on rows near a
        threshold (or a pixel edge) in a view of either; the counts."""
        differ = a["active"] != b["active"]
        near_depth = a["near_depth"] | b["near_depth"]
        near_edge = (a["near_edge"] | b["near_edge"]) & ~near_depth
        bad = np.nonzero(differ & ~near_depth & ~near_edge)[0]
        assert not len(bad), (f"{len(bad)} rows decided otherwise with no "
                              f"threshold near: {bad[:20].tolist()}")
        return dict(rows_differ=int(differ.sum()),
                    differ_near_depth=int((differ & near_depth).sum()),
                    differ_near_edge=int((differ & near_edge).sum()),
                    rows_near_depth=int(near_depth.sum()),
                    rows_near_edge=int(near_edge.sum()))

    def prune_full_width(self) -> dict:
        """One prune_view on view 0 of the full scene with a prior of sky on
        its left half and nearer than every Gaussian on its right: the
        kernel render's mask against the plain render's, and the time of
        render + prune_view."""
        t, T, k = self.torch, self.testing, self.kernels
        from priordepth_gaussiansplatting_torch.train import prune
        g = T.random_gaussians(0, FULL_N, extent=1.0,
                               scale_range=(0.001, 0.004))
        state = self.state(g)
        opt = self.optim.init_adam(state.params)
        prior = np.full((FULL_H, FULL_W), FULL_PRIOR[1], np.float32)
        prior[:, :FULL_W // 2] = FULL_PRIOR[0]
        cam = T.look_at_camera(FULL_EYES[0], width=FULL_W, height=FULL_H,
                               device=self.dev, invdepth=prior,
                               depth_reliable=True)
        bg = t.zeros(3, device=self.dev)

        def view():
            out = self.render.render(cam, state, bg, antialiasing=True,
                                     backend="kernels")
            st, _, _, n_del = prune.prune_view(
                state, opt, prune.FeatureTable.empty(device=self.dev), cam,
                out["invdepth"], out["radii"], FULL_EXTENT)
            return st, n_del, out

        res = {}
        for name in ("kernels", "plain"):
            with (self.plain_kernels() if name == "plain"
                  else contextlib.nullcontext()):
                t.cuda.synchronize()
                k.reset_launch_counts()
                st, n_del, out = view()
                t.cuda.synchronize()
                launches = k.launch_counts()
                assert int(out["overflow"]) == 0
                terms = prune.view_terms(state, cam, out["invdepth"],
                                         out["radii"])
                d, e = self.prune_near(state, terms, FULL_EXTENT)
                res[name] = dict(active=st.active.cpu().numpy(),
                                 near_depth=d.cpu().numpy(),
                                 near_edge=e.cpu().numpy(),
                                 deleted=int(n_del),
                                 valid=int(terms.valid.sum()),
                                 launches={n: launches[n] for n in FORWARD})
        assert res["kernels"]["launches"] == dict.fromkeys(FORWARD, 1), res
        assert not any(res["plain"]["launches"].values()), res
        agree = self.masks_agree(res["kernels"], res["plain"])
        deleted = res["kernels"]["deleted"]
        # A real share: at least 1 % of the rows the view judges (a row
        # behind others reads a nearer rendered depth and stays).
        assert deleted >= 0.01 * res["kernels"]["valid"], res["kernels"]
        ms = cuda_ms(t, view, reps=10)
        return dict(n=FULL_N, width=FULL_W, height=FULL_H, prior=FULL_PRIOR,
                    extent=FULL_EXTENT, deleted=deleted,
                    deleted_plain=res["plain"]["deleted"],
                    valid=res["kernels"]["valid"],
                    launches=res["kernels"]["launches"],
                    render_and_prune_view_ms=ms, **agree)

    def phase_thesis(self):
        """The thesis events through the train CLI on train_cli's scene
        with depth priors, then the prune loop from the checkpoint before
        the prune on the card with the kernels, on the card with their
        plain versions and on the CPU; then one prune view at full
        width."""
        t = self.torch
        size, views = CLI_SCENE
        scene = self.cli_scene
        t0 = time.perf_counter()
        self.testing.write_depth_priors(scene, size, views)
        priors_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            model = os.path.join(tmp, "model")
            evals = [CLI_CHECK, THESIS_INJECT - 1, THESIS_INJECT,
                     THESIS_PRUNE - 1, THESIS_PRUNE, CLI_ITERS]
            run = self.train_cli(
                ["-s", scene, "-m", model, "-d", "depths",
                 "--iterations", str(CLI_ITERS),
                 "--test_iterations"] + [str(i) for i in evals] + [
                 "--save_iterations", str(CLI_ITERS),
                 "--checkpoint_iterations", str(THESIS_PRUNE - 1),
                 "--noise_injection_iter", str(THESIS_INJECT),
                 "--floating_prune_iter", str(THESIS_PRUNE)])
            assert run["iterations_run"] == CLI_ITERS
            inj, prn = run["events"]
            assert (inj["event"], inj["iteration"]) == ("inject",
                                                        THESIS_INJECT)
            assert inj["n_active"] == inj["n_active_before"] + 6, inj
            assert inj["launches"] == {}, inj
            assert (f"[it {THESIS_INJECT}] injected noise gaussians "
                    f"(n_active={inj['n_active']}, +6)") in run["out"]
            assert (prn["event"], prn["iteration"]) == ("prune",
                                                        THESIS_PRUNE)
            assert prn["overflowed_views"] == 0, prn
            rendered = len(prn["history"])
            assert rendered >= views * 7 // 8 and prn["deleted"] >= 1, prn
            assert prn["launches"] == dict.fromkeys(FORWARD, rendered), prn
            assert (f"[it {THESIS_PRUNE}] floating-object prune: deleted "
                    f"{prn['deleted']} over {prn['views']} views"
                    ) in run["out"]
            ev = read_events(model)
            psnr, train_psnr, steady = run_readings(ev, CLI_CHECK + 50,
                                                    THESIS_INJECT - 50)
            _, _, with_events = run_readings(ev, CLI_CHECK + 50,
                                             CLI_ITERS - 50)
            assert sorted(psnr) == evals, psnr
            assert all(np.isfinite(v) for v in psnr.values()), psnr

            # The CPU's loop runs in a process of its own meanwhile.
            ck = os.path.join(model, f"chkpnt{THESIS_PRUNE - 1}.pkl")
            with concurrent.futures.ProcessPoolExecutor(
                    1, mp_context=multiprocessing.get_context("spawn")) as ex:
                cpu = ex.submit(prune_on_cpu, ck, scene)
                loops = {"kernels": self.prune_run(ck, scene, self.dev),
                         "plain": self.prune_run(ck, scene, self.dev,
                                                 plain=True)}
                full = self.prune_full_width()
                loops["cpu"] = cpu.result()
        n = len(loops["kernels"]["info"]["history"])
        assert loops["kernels"]["launches"] == dict.fromkeys(FORWARD, n)
        for name in ("plain", "cpu"):
            assert not any(loops[name]["launches"].values()), loops[name]
        agree = {f"kernels_vs_{name}": self.masks_agree(loops["kernels"],
                                                        loops[name])
                 for name in ("plain", "cpu")}
        emit("thesis", ok=True, scene=dict(size=size, views=views,
                                           priors_s=priors_s),
             iterations=CLI_ITERS, wall_s=run["wall_s"],
             it_per_s_before_events=steady,
             it_per_s_with_events=with_events,
             train_cli_it_per_s=self.results["train_cli"][
                 "it_per_s_between_evals"],
             inject={k: inj[k] for k in ("iteration", "n_active_before",
                                         "n_active", "seconds")},
             prune={k: prn[k] for k in ("iteration", "n_active_before",
                                        "n_active", "deleted", "views",
                                        "history", "overflowed_views",
                                        "launches", "seconds")},
             step_launches=run["step_launches"], skipped=run["skipped"],
             test_psnr=psnr, train_psnr=train_psnr,
             loops_from=f"chkpnt{THESIS_PRUNE - 1}", seed=THESIS_SEED,
             loops={name: dict(history=r["info"]["history"],
                               deleted=r["info"]["total_deleted"],
                               views=r["info"]["epochs"],
                               n_active=r["n_active"], seconds=r["seconds"],
                               launches=r["launches"])
                    for name, r in loops.items()},
             masks=agree, full_width=full)

    def phase_metrics(self):
        """The metrics CLI on the render CLI's output of phase train_cli
        (its held-out views at CLI_ITERS), with random VGG16 LPIPS weights:
        on the card against ``--device cpu``, and its PSNR beside the
        trainer's report for the same views and iteration."""
        model = self.cli_model
        weights = os.path.join(self.work, "lpips_random.npz")
        random_vgg16_npz(weights)
        method = f"ours_{CLI_ITERS}"
        res, seconds = {}, {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out = self.run_cmd(
                [sys.executable, "-m", "priordepth_gaussiansplatting_torch."
                 "metrics", "-m", model, "--device", device], 600,
                env={"PDGS_LPIPS_WEIGHTS": weights})
            seconds[device] = time.perf_counter() - t0
            assert "WARNING" not in out and "LPIPS:" in out, out
            with open(os.path.join(model, "results.json")) as f:
                res[device] = json.load(f)[method]
            with open(os.path.join(model, "per_view.json")) as f:
                res[device + "_views"] = json.load(f)[method]
        card, cpu = res["cuda"], res["cpu"]
        assert set(card) == set(cpu) == {"SSIM", "PSNR", "LPIPS"}, res
        for key in ("SSIM", "PSNR"):
            assert abs(card[key] - cpu[key]) <= METRICS_ATOL, (key, res)
        assert abs(card["LPIPS"] - cpu["LPIPS"]) <= LPIPS_RTOL * abs(
            cpu["LPIPS"]), res
        report = self.results["train_cli"]["test_psnr"][CLI_ITERS]
        gap = self.render_gap()
        # The in-process render at the render CLI's capacity, as 8-bit PNG
        # values, is what the metrics CLI scored.
        assert abs(gap["default"]["png_psnr"] - card["PSNR"]) <= 0.01, (
            gap, card)
        emit("metrics", ok=True, model="train_cli", method=method,
             views=len(res["cuda_views"]["PSNR"]), card=card, cpu=cpu,
             per_view_psnr=res["cuda_views"]["PSNR"], seconds=seconds,
             lpips_weights="random VGG16 (numpy seed 0)",
             report_test_psnr=report, metrics_test_psnr=card["PSNR"],
             report_minus_metrics_db=report - card["PSNR"], render_gap=gap)

    def render_gap(self) -> dict:
        """train_cli's snapshot rendered in-process as the render CLI
        renders it (the loaded store's default pair capacity) and at the
        run's pinned CLI_PAIRS: per held-out view its overflow and PSNR, on
        the float image and on 8-bit values as the render CLI writes them
        (truncated), and their means."""
        t = self.torch
        from priordepth_gaussiansplatting_torch.data.dataset import Scene
        from priordepth_gaussiansplatting_torch.ops import losses
        from priordepth_gaussiansplatting_torch.train import checkpoint
        state = checkpoint.load_model_snapshot(self.cli_model, CLI_ITERS,
                                               device=self.dev)
        scene = Scene(self.cli_scene, eval_split=True, shuffle=False,
                      device=self.dev)
        bg = t.zeros(3, device=self.dev)

        def png(img):
            return (t.clamp(img, 0, 1) * 255).to(t.uint8).float() / 255

        out = {"store_rows": state.capacity,
               "default_pair_capacity":
                   self.rasterize.default_pair_capacity(state.capacity),
               "pinned_pair_capacity": CLI_PAIRS}
        for label, cap in (("default", None), ("pinned", CLI_PAIRS)):
            views = []
            for cam in scene.test_cameras:
                r = self.step.eval_image(cam, state, bg, backend="kernels",
                                         pair_capacity=cap)
                views.append(dict(
                    overflow=int(r["overflow"]), psnr=float(r["psnr"]),
                    png_psnr=float(losses.psnr(png(r["render"]),
                                               png(cam.image)))))
            out[label] = dict(views=views, **{
                k: float(np.mean([v[k] for v in views]))
                for k in ("psnr", "png_psnr")})
        return out

    # --- depth-prior inference and the network viewer -----------------------

    def depth_model(self):
        """(config, the repo's depth model with weights from DEPTH_SEED on
        the card), made once."""
        if getattr(self, "_depth", None) is None:
            from priordepth_gaussiansplatting_torch.depth import config
            cfg = config.get_config("depth", "infer", "nyu")
            self._depth = (cfg, config.build_model(
                cfg, generator=self.torch.Generator().manual_seed(DEPTH_SEED),
                device=self.dev).eval())
        return self._depth

    def phase_depth(self):
        """The depth-prior inference path on the card: TTA priors of
        train_cli's images, the card against the CPU, fused attention
        against the plain form, DepthModelNK once, and a ViT-L encoder
        imported from a DINOv2-layout state dict."""
        t, t_phase = self.torch, time.perf_counter()
        from PIL import Image
        from priordepth_gaussiansplatting_torch.depth import (config, infer,
                                                              layers)
        cfg, model = self.depth_model()
        images = os.path.join(self.cli_scene, "images")
        names = sorted(os.listdir(images))
        out_dir = os.path.join(self.work, "depth_priors")
        infer.generate_depth_priors(model, images, out_dir, device=self.dev)
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        written = infer.generate_depth_priors(model, images, out_dir,
                                              device=self.dev)
        t.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        peak = t.cuda.max_memory_allocated() / 2 ** 30
        assert len(written) == len(names), (written, names)
        levels = []
        for path in written:
            png = np.asarray(Image.open(path))
            assert png.dtype == np.uint16 and png.shape == CLI_SCENE[:1] * 2
            levels.append(int(png.max()) - int(png.min()))
        assert min(levels) > 0, levels
        with Image.open(os.path.join(images, names[0])) as im:
            arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
            x = t.from_numpy(arr)[None].to(self.dev)
            d_card = infer.infer_pil(model, im, device=self.dev)
            cpu_model = config.build_model(
                cfg, generator=t.Generator().manual_seed(DEPTH_SEED),
                device="cpu").eval()
            t0 = time.perf_counter()
            d_cpu = infer.infer_pil(cpu_model, im, device="cpu")
            cpu_s = time.perf_counter() - t0
        del cpu_model
        card_vs_cpu = float(np.abs(d_card - d_cpu).max()
                            / np.abs(d_cpu).max())
        assert np.isfinite(d_card).all() and card_vs_cpu <= DEPTH_RTOL, (
            card_vs_cpu)
        # The CPU's prior PNG of that image, as generate_depth_priors
        # writes it, against the card's batch job's.
        cpu_png = os.path.join(self.work, "depth_prior_cpu.png")
        infer.save_invdepth_png(cpu_png, d_cpu)
        png_levels = int(np.abs(
            np.asarray(Image.open(cpu_png), np.int64)
            - np.asarray(Image.open(written[0]), np.int64)).max())
        assert png_levels <= 1, png_levels
        ms = {"tta_flip": cuda_ms(t, lambda: infer.infer_with_tta(model, x),
                                  reps=5),
              "tta_no_flip": cuda_ms(t, lambda: infer.infer_with_tta(
                  model, x, with_flip=False), reps=5)}
        # The TTA's input size: the fused attention against the plain form.
        side = 2 * CLI_SCENE[0]
        xin = t.rand((1, 3, side, side), generator=t.Generator(
            self.dev).manual_seed(1), device=self.dev)
        with t.inference_mode():
            fused = model(xin)["metric_depth"]
            ms["forward_fused"] = cuda_ms(t, lambda: model(xin), reps=5)
            layers.use_fused_attention(model, False)
            plain = model(xin)["metric_depth"]
            ms["forward_plain_attention"] = cuda_ms(t, lambda: model(xin),
                                                    reps=5)
            layers.use_fused_attention(model, True)
        fused_vs_plain = float((fused - plain).abs().max()
                               / plain.abs().max())
        assert fused_vs_plain <= DEPTH_RTOL, fused_vs_plain
        nk = self.depth_nk_once(x)
        vitl = self.vitl_once()
        emit("depth", ok=True, config={k: cfg[k] for k in (
                 "embed_dim", "encoder_depth", "n_bins", "min_depth",
                 "max_depth", "bin_centers_type")},
             weights=f"random, torch.Generator seed {DEPTH_SEED}",
             images=len(written), image_size=list(arr.shape[:2]),
             tta_input=[side, side], patches=(side // 16) ** 2,
             batch_s=batch_s, ms_per_image_batch=1e3 * batch_s / len(written),
             ms=ms, peak_mem_gib=peak, prior_levels_min=min(levels),
             card_vs_cpu_rel=card_vs_cpu, card_vs_cpu_png_levels=png_levels,
             cpu_tta_s=cpu_s, fused_vs_plain_attention_rel=fused_vs_plain,
             nk=nk, vitl=vitl, seconds=time.perf_counter() - t_phase,
             nvidia_smi=self.smi)

    def depth_nk_once(self, x) -> dict:
        """DepthModelNK (config depth_nk, dataset mix) on one 512² image,
        soft and hard route, against the same model on the CPU."""
        t = self.torch
        from priordepth_gaussiansplatting_torch.depth import config
        cfg = config.get_config("depth_nk", "infer", "mix")
        out, models = {}, {}
        xin = x.permute(0, 3, 1, 2).contiguous()
        for label, device in (("card", self.dev), ("cpu", t.device("cpu"))):
            nk = models[label] = config.build_model(
                cfg, generator=t.Generator().manual_seed(DEPTH_SEED),
                device=device).eval()
            with t.inference_mode():
                out[label] = [nk(xin.to(device), hard_route=h)
                              for h in (False, True)]
        soft, hard = out["card"]
        assert soft["metric_depth"].shape == (1,) + tuple(x.shape[1:3])
        assert bool(t.isfinite(soft["metric_depth"]).all())
        assert bool(t.isfinite(hard["metric_depth"]).all())
        errs = [float((a["metric_depth"].cpu() - b["metric_depth"]).abs()
                      .max() / b["metric_depth"].abs().max())
                for a, b in zip(out["card"], out["cpu"])]
        assert max(errs) <= DEPTH_RTOL, errs
        with t.inference_mode():
            ms = cuda_ms(t, lambda: models["card"](xin), reps=5)
        return dict(card_vs_cpu_rel={"soft": errs[0], "hard": errs[1]},
                    domain_logits=soft["domain_logits"].cpu().tolist()[0],
                    input=list(xin.shape[2:]), forward_ms=ms)

    def vitl_once(self) -> dict:
        """A random DINOv2-layout ViT-L state dict, written with torch.save,
        loaded and converted by ``depth/import_torch.py``, run at 518² on
        the card against the CPU."""
        t = self.torch
        from priordepth_gaussiansplatting_torch.depth import (import_torch,
                                                              model)
        g = t.Generator().manual_seed(DEPTH_SEED)
        e, n, p = VITL["embed_dim"], VITL["depth"], VITL["patch_size"]
        grid = VITL_SIDE // p

        def rnd(*shape, scale=0.02, base=0.0):
            return base + scale * t.randn(shape, generator=g)
        sd = {"patch_embed.proj.weight": rnd(e, 3, p, p),
              "patch_embed.proj.bias": rnd(e),
              "cls_token": rnd(1, 1, e), "mask_token": rnd(1, e),
              "pos_embed": rnd(1, 1 + grid * grid, e),
              "norm.weight": rnd(e, base=1.0), "norm.bias": rnd(e)}
        for i in range(n):
            b = f"blocks.{i}."
            sd.update({b + "norm1.weight": rnd(e, base=1.0),
                       b + "norm1.bias": rnd(e),
                       b + "attn.qkv.weight": rnd(3 * e, e),
                       b + "attn.qkv.bias": rnd(3 * e),
                       b + "attn.proj.weight": rnd(e, e),
                       b + "attn.proj.bias": rnd(e),
                       b + "ls1.gamma": rnd(e, scale=0.01, base=0.1),
                       b + "norm2.weight": rnd(e, base=1.0),
                       b + "norm2.bias": rnd(e),
                       b + "mlp.fc1.weight": rnd(4 * e, e),
                       b + "mlp.fc1.bias": rnd(4 * e),
                       b + "mlp.fc2.weight": rnd(e, 4 * e),
                       b + "mlp.fc2.bias": rnd(e),
                       b + "ls2.gamma": rnd(e, scale=0.01, base=0.1)})
        path = os.path.join(self.work, "vitl_dinov2_random.pth")
        t.save({"model": {"pretrained." + k: v for k, v in sd.items()}},
               path)
        del sd
        t0 = time.perf_counter()
        enc_sd, geo = import_torch.convert_vit_state_dict(
            import_torch.load_state_dict(path), target_grid=(grid, grid))
        import_s = time.perf_counter() - t0
        os.remove(path)
        want = dict(embed_dim=e, depth=n, num_heads=VITL["num_heads"],
                    patch_size=p,
                    use_cls_token=True, num_register_tokens=0,
                    layerscale=True, final_norm=True)
        assert all(geo[k] == v for k, v in want.items()), geo
        with t.device("meta"):
            enc = model.ViTEncoder(**VITL)
        enc.load_state_dict(enc_sd, assign=True)
        enc.eval()
        del enc_sd
        x = t.rand((1, 3, VITL_SIDE, VITL_SIDE),
                   generator=t.Generator().manual_seed(2))
        t0 = time.perf_counter()
        with t.inference_mode():
            want_feats = enc(x)
        cpu_s = time.perf_counter() - t0
        enc = enc.to(self.dev)
        xc = x.to(self.dev)
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        with t.inference_mode():
            feats = enc(xc)
            ms = cuda_ms(t, lambda: enc(xc), reps=5)
        peak = t.cuda.max_memory_allocated() / 2 ** 30
        assert len(feats) == len(VITL["taps"]) + 1
        errs = [float((f.cpu() - w).abs().max() / w.abs().max())
                for f, w in zip(feats, want_feats)]
        assert all(bool(t.isfinite(f).all()) for f in feats)
        assert max(errs) <= DEPTH_RTOL, errs
        params = sum(v.numel() for v in enc.parameters())
        del enc
        return dict(geometry=geo, params=params, side=VITL_SIDE,
                    tokens=1 + grid * grid, ms=ms, peak_mem_gib=peak,
                    card_vs_cpu_rel=errs, cpu_s=cpu_s, import_s=import_s)

    def observe_points(self, scene: str) -> list:
        """Give the scene's ``images.bin`` 2D observations
        (``utils/standins.py::observed_model``); their counts per view."""
        from priordepth_gaussiansplatting_torch.data import colmap as cm
        from priordepth_gaussiansplatting_torch.utils import standins
        sparse = os.path.join(scene, "sparse", "0")
        _, images, _ = standins.observed_model(sparse)
        cm.write_images_binary(images, os.path.join(sparse, "images.bin"))
        return [len(im.point3D_ids) for im in images.values()]

    def phase_depth_chain(self):
        """The thesis's prior chain on train_cli's scene: 2D observations
        for the sparse points, TTA priors by the depth model on the card,
        ``make_depth_scale``, then the train CLI with ``-d depths``."""
        import shutil
        from priordepth_gaussiansplatting_torch.data import depth_scale
        from priordepth_gaussiansplatting_torch.depth import infer
        t_phase = time.perf_counter()
        scene = os.path.join(self.work, "chain_scene")
        shutil.copytree(self.cli_scene, scene,
                        ignore=shutil.ignore_patterns("depths"))
        observed = self.observe_points(scene)
        assert min(observed) > 10, observed
        _, model = self.depth_model()
        t0 = time.perf_counter()
        written = infer.generate_depth_priors(
            model, os.path.join(scene, "images"),
            os.path.join(scene, "depths"), device=self.dev)
        priors_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = depth_scale.make_depth_scale(scene,
                                              os.path.join(scene, "depths"))
        scale_s = time.perf_counter() - t0
        with open(os.path.join(scene, "sparse", "0",
                               "depth_params.json")) as f:
            on_disk = json.load(f)
        assert on_disk and on_disk == params, "empty depth_params.json"
        assert len(params) == len(written) == CLI_SCENE[1], len(params)
        fitted = [p for p in params.values() if p["scale"] != 0]
        assert fitted and all(np.isfinite([p["scale"], p["offset"]]).all()
                              for p in params.values()), params
        with tempfile.TemporaryDirectory() as tmp:
            model_dir = os.path.join(tmp, "model")
            run = self.train_cli(
                ["-s", scene, "-m", model_dir, "-d", "depths",
                 "--iterations", str(CHAIN_ITERS), "--test_iterations",
                 str(CHAIN_ITERS), "--save_iterations", str(CHAIN_ITERS)])
            ev = read_events(model_dir)
        losses = [e["value"] for e in ev
                  if e.get("tag") == "train_loss_patches/total_loss"]
        psnr = {e["step"]: e["value"] for e in ev
                if e.get("tag") == "test/loss_viewpoint - psnr"}
        assert run["iterations_run"] == CHAIN_ITERS and run["skipped"] == 0
        assert losses and np.isfinite(losses).all(), losses
        assert np.isfinite(run["final_loss"]), run
        scales = sorted(p["scale"] for p in fitted)
        emit("depth_chain", ok=True, views=len(written),
             observations_per_view=[min(observed), max(observed)],
             priors_s=priors_s, depth_scale_s=scale_s, fitted=len(fitted),
             scale_median=scales[len(scales) // 2],
             iterations=CHAIN_ITERS, wall_s=run["wall_s"],
             final_loss=run["final_loss"], test_psnr=psnr,
             step_launches=run["step_launches"], skipped=run["skipped"],
             seconds=time.perf_counter() - t_phase)

    def phase_chain(self):
        """The chain CLIs on train_cli's scene: ``train_video`` ->
        ``train_image`` -> ``convert`` -> ``run.py`` -> ``make_depth_scale``
        -> the train CLI on the card, through stand-ins for ffmpeg, COLMAP,
        DepthAnythingV2 and the SIBR app (``utils/standins.py``), then
        ``SIBR_viewer --with_metrics``, ``convert`` with a failing COLMAP,
        and the native COLMAP reader at a real capture's size."""
        from priordepth_gaussiansplatting_torch.utils import standins
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            st = standins.write_chain_standins(
                os.path.join(tmp, "bin"), self.cli_scene,
                depth_seed=DEPTH_SEED)
            video, work, model = (os.path.join(tmp, name)
                                  for name in ("video.mp4", "work", "model"))
            with open(video, "wb") as f:
                f.write(b"a stand-in ffmpeg reads no video")
            env = {"PATH": st["path"] + os.pathsep + os.environ["PATH"]}
            # train_cli's flags; "-m" not first, where the chain CLIs'
            # argparse would take the string for their own -m.
            train_args = " ".join([
                "--eval", "--disable_viewer", "--noise_injection_iter", "0",
                "--floating_prune_iter", "0", "--init_capacity",
                str(CLI_CAPACITY), "--pin_pair_capacity", str(CLI_PAIRS),
                "--iterations", str(CHAIN_ITERS), "--test_iterations",
                str(CHAIN_ITERS), "--save_iterations", str(CHAIN_ITERS),
                "-m", model])
            t0 = time.perf_counter()
            with card_memory_peak() as mem:
                out = self.run_cmd(
                    [sys.executable, "-m", PORT + "train_video", "-v", video,
                     "-w", work, "--fps", "2", "--depth_anything_dir",
                     st["depth_anything_dir"], "--train_args", train_args],
                    900, env=env)
            chain_s = time.perf_counter() - t0
            run = self.chain_run(out, st, work, model)
            t0 = time.perf_counter()
            self.run_cmd([sys.executable, "-m", PORT + "SIBR_viewer", "-m",
                          model, "--with_metrics", "--viewer_path",
                          st["viewer_dir"]], 900, env=env)
            sibr_s = time.perf_counter() - t0
            method = f"ours_{CHAIN_ITERS}"
            for split in ("train", "test"):
                rdir = os.path.join(model, split, method, "renders")
                assert len(os.listdir(rdir)) > 0, rdir
            with open(os.path.join(model, "results.json")) as f:
                scores = json.load(f)[method]
            assert np.isfinite(scores["PSNR"]), scores
            app = standins.read_log(st["log"])[-1]
            assert app["tool"] == "viewer/SIBR_gaussianViewer_app", app
            assert app["argv"] == ["-m", model], app
            failing = subprocess.run(
                [sys.executable, "-m", PORT + "convert", "-s",
                 os.path.join(tmp, "failing"), "--colmap_executable",
                 st["colmap_fail"]], cwd=REPO, capture_output=True,
                text=True, env=dict(os.environ, PYTHONPATH=REPO),
                timeout=300)
            assert failing.returncode == 3, (failing.returncode,
                                             failing.stdout, failing.stderr)
            native = self.native_reader(tmp)
        emit("chain", ok=True, standins=list(standins.STANDINS),
             standins_note="ffmpeg, COLMAP, DepthAnythingV2 and SIBR are "
                           "stand-ins that act out train_cli's scene",
             scene=dict(size=CLI_SCENE[0], views=CLI_SCENE[1]),
             chain_s=chain_s, card_memory_used_peak_mib=mem["peak_mib"],
             **run, sibr_viewer_s=sibr_s, metrics=scores,
             failing_colmap_convert_rc=failing.returncode, native=native,
             seconds=time.perf_counter() - t_phase, nvidia_smi=self.smi)

    def chain_run(self, out: str, st: dict, work: str, model: str) -> dict:
        """What ``train_video``'s run shows: the reference scripts'
        commands in order, the stand-ins' work, ``sparse/0``, the fitted
        ``depth_params.json``, and the train CLI's 300 iterations with
        ``-d depths`` on the card through each step kernel."""
        from priordepth_gaussiansplatting_torch.utils import standins
        cmds = [ln[2:] for ln in out.splitlines() if ln.startswith("$ ")]
        heads = [c.split(" --")[0].split(" -s ")[0].split(" -i ")[0]
                 for c in cmds]
        colmap = os.path.join(st["path"], "colmap")
        assert heads == [
            os.path.join(st["path"], "ffmpeg"),
            f"{sys.executable} -m {PORT}train_image",
            f"{sys.executable} -m {PORT}convert",
            f"{colmap} feature_extractor", f"{colmap} exhaustive_matcher",
            f"{colmap} mapper", f"{colmap} image_undistorter",
            f"{sys.executable} {st['depth_anything_dir']}/run.py",
            f"{sys.executable} -m {PORT}train"], heads
        assert " -d depths " in cmds[-1], cmds[-1]
        log = standins.read_log(st["log"])
        assert [r["tool"] for r in log] == ["ffmpeg"] + ["colmap"] * 4 + [
            "depth_anything/run.py"], log
        assert all(r["code"] == 0 for r in log), log
        depth = log[-1]
        assert depth["device"].startswith(self.dev.type), depth
        assert depth["written"] == CLI_SCENE[1], depth
        observed = log[3]["observations"]
        assert min(observed) > 10, observed
        sparse = os.path.join(work, "sparse", "0")
        files = sorted(os.listdir(sparse))
        assert {"cameras.bin", "images.bin", "points3D.bin"} <= set(files)
        with open(os.path.join(sparse, "depth_params.json")) as f:
            params = json.load(f)
        assert len(params) == CLI_SCENE[1], params
        assert all(np.isfinite([p["scale"], p["offset"]]).all()
                   for p in params.values()), params
        fitted = sorted(p["scale"] for p in params.values() if p["scale"])
        assert fitted, params
        last = out.strip().splitlines()[-1]
        assert last.startswith("Training complete: "), last
        res = json.loads(last[len("Training complete: "):])
        assert res["iterations_run"] == CHAIN_ITERS and res["skipped"] == 0
        assert res["step_launches"] == dict.fromkeys(STEP, CHAIN_ITERS), res
        assert np.isfinite(res["final_loss"]), res
        ev = read_events(model)
        losses = [e["value"] for e in ev
                  if e.get("tag") == "train_loss_patches/total_loss"]
        assert losses and np.isfinite(losses).all(), losses
        psnr, train_psnr, steady = run_readings(ev, 50, CHAIN_ITERS - 50)
        assert np.isfinite(psnr[CHAIN_ITERS]), psnr
        return dict(
            commands=[h.replace(sys.executable, "python") for h in heads],
            standin_seconds={f"{r['tool']} {r['argv'][0]}"
                             if r["tool"] == "colmap" else r["tool"]:
                             r["seconds"] for r in log},
            depth_peak_mem_gib=depth.get("peak_mem_gib"),
            observations_per_view=[min(observed), max(observed)],
            sparse0=files, fitted=len(fitted),
            scale_median=fitted[len(fitted) // 2],
            iterations=CHAIN_ITERS, wall_s=res["wall_s"],
            it_per_s_between_evals=steady, final_loss=res["final_loss"],
            test_psnr=psnr, train_psnr=train_psnr,
            step_launches=res["step_launches"], skipped=res["skipped"])

    def native_reader(self, tmp: str) -> dict:
        """A sparse model of a Mip-NeRF 360 capture's size written with the
        port's writers (observation o: image o % 200, point o // 10), read
        by the native and the Python readers, equal field by field; the
        library is loaded directly, so that a failed build fails here."""
        from priordepth_gaussiansplatting_torch.data import colmap as cm
        from priordepth_gaussiansplatting_torch.data import native
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        native.load_library()
        load_s = time.perf_counter() - t0
        n_obs = NATIVE_IMAGES * NATIVE_P2D
        assert n_obs == NATIVE_POINTS * NATIVE_TRACK
        obs = np.arange(n_obs).reshape(NATIVE_P2D, NATIVE_IMAGES)
        xys = rng.random((NATIVE_IMAGES, NATIVE_P2D, 2)) * 1000
        images = {}
        for i in range(NATIVE_IMAGES):
            q = rng.standard_normal(4)
            images[i + 1] = cm.ColmapImage(
                i + 1, q / np.linalg.norm(q), rng.standard_normal(3), 1,
                f"frame_{i:05d}.jpg", xys[i],
                (obs[:, i] // NATIVE_TRACK + 1).astype(np.int64))
        track = np.arange(n_obs).reshape(NATIVE_POINTS, NATIVE_TRACK)
        xyz = rng.standard_normal((NATIVE_POINTS, 3))
        rgb = rng.integers(0, 256, (NATIVE_POINTS, 3))
        err = rng.random(NATIVE_POINTS)
        points = {j + 1: cm.ColmapPoint3D(
            j + 1, xyz[j], rgb[j], float(err[j]),
            (track[j] % NATIVE_IMAGES + 1).astype(np.int32),
            (track[j] // NATIVE_IMAGES).astype(np.int32))
            for j in range(NATIVE_POINTS)}
        ipath = os.path.join(tmp, "images.bin")
        ppath = os.path.join(tmp, "points3D.bin")
        t0 = time.perf_counter()
        cm.write_images_binary(images, ipath)
        cm.write_points3D_binary(points, ppath)
        write_s = time.perf_counter() - t0
        seconds, read = {}, {}
        for name, fns in (("native", (native.read_images_binary,
                                      native.read_points3D_binary)),
                          ("python", (cm.read_images_binary,
                                      cm.read_points3D_binary))):
            t0 = time.perf_counter()
            read[name] = (fns[0](ipath), fns[1](ppath))
            seconds[name] = time.perf_counter() - t0
        (ni, np_), (pi, pp) = read["native"], read["python"]
        assert list(ni) == list(pi) == list(images)
        for k, want in pi.items():
            got = ni[k]
            assert (got.id, got.camera_id, got.name) == (
                want.id, want.camera_id, want.name)
            for field in ("qvec", "tvec", "xys", "point3D_ids"):
                assert np.array_equal(getattr(got, field),
                                      getattr(want, field)), (k, field)
        assert list(np_) == list(pp) == list(points)
        for field in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            assert np.array_equal(
                np.stack([getattr(p, field) for p in np_.values()]),
                np.stack([getattr(p, field) for p in pp.values()])), field
        assert [p.error for p in np_.values()] == [p.error
                                                  for p in pp.values()]
        return dict(images=NATIVE_IMAGES, points2d_per_image=NATIVE_P2D,
                    points=NATIVE_POINTS, track=NATIVE_TRACK,
                    observations=n_obs,
                    file_mib=(os.path.getsize(ipath)
                              + os.path.getsize(ppath)) / 2 ** 20,
                    library=str(native.library_path().name),
                    load_s=load_s, write_s=write_s, read_s=seconds,
                    speedup=seconds["python"] / seconds["native"])

    def drive_viewer(self, gui, state, bg, message, n: int):
        """`n` requests of one camera from a client thread, served by one
        poll (``keep_alive`` on all but the last): the images and each
        request's round trip in ms, as the client sees it."""
        replies, times = [], []
        # Connected before the poll, which accepts without waiting.
        c = self.testing.ViewerClient("127.0.0.1", gui.port)

        def client():
            try:
                for i in range(n):
                    t0 = time.perf_counter()
                    img, verify = c.request(dict(message,
                                                 keep_alive=i < n - 1))
                    times.append(1e3 * (time.perf_counter() - t0))
                    replies.append(img)
            finally:
                c.close()
        th = threading.Thread(target=client, daemon=True)
        th.start()
        gui.poll(state, bg, source_path=self.cli_scene)
        th.join(120)
        assert not th.is_alive() and len(replies) == n, (
            f"{len(replies)} of {n} viewer images came back")
        gui.poll(state, bg)  # the closed connection is dropped
        return replies, times

    def phase_viewer(self):
        """The network viewer on the card: a client over loopback asks for
        a held-out view of train_cli's checkpoint at 512² and for view 0 of
        the full scene at 1600x1066; every image equals a direct render
        through the kernels and lies within one level of the plain
        versions'. Then the train CLI with the viewer on, held by a client
        for VIEWER_HELD requests."""
        t, k, T = self.torch, self.kernels, self.testing
        t_phase = time.perf_counter()
        from priordepth_gaussiansplatting_torch.data.dataset import Scene
        from priordepth_gaussiansplatting_torch.train import checkpoint
        from priordepth_gaussiansplatting_torch.viewer import network_gui as ng
        state, _, _ = checkpoint.load_checkpoint(
            os.path.join(self.cli_model, f"chkpnt{CLI_CHECK}.pkl"),
            device=self.dev)
        scene = Scene(self.cli_scene, eval_split=True, shuffle=False,
                      device=self.dev)
        full = self.state(T.random_gaussians(0, FULL_N, extent=1.0,
                                             scale_range=(0.001, 0.004)))
        wide = T.look_at_camera(FULL_EYES[0], width=FULL_W, height=FULL_H,
                                device=self.dev)
        bg = t.zeros(3, device=self.dev)

        def image(out):
            return (t.clamp(out["render"], 0, 1) * 255).to(t.uint8).permute(
                1, 2, 0).cpu().numpy()

        gui = ng.NetworkGUI("127.0.0.1", 0, device=self.dev)
        views = {}
        try:
            for label, st, cam in (
                    ("cli_512", state, scene.test_cameras[0]),
                    ("full_1600x1066", full, wide)):
                msg = T.camera_message(cam)
                t.cuda.synchronize()
                # The viewer's path: every count at 0 just before, read
                # just after.
                k.reset_launch_counts()
                replies, times = self.drive_viewer(gui, st, bg, msg,
                                                   VIEWER_REQUESTS)
                launches = k.launch_counts()
                assert launches == {n: (VIEWER_REQUESTS if n in FORWARD
                                        else 0) for n in launches}, launches
                direct = self.render.render(cam, st, bg)
                want = image(direct)
                with self.plain_kernels():
                    plain = image(self.render.render(cam, st, bg))
                assert all(np.array_equal(r, want) for r in replies), label
                plain_diff = int(np.abs(want.astype(int)
                                        - plain.astype(int)).max())
                assert plain_diff <= 1, (label, plain_diff)
                assert want.std() > 0
                views[label] = dict(
                    width=cam.width, height=cam.height, rows=st.capacity,
                    requests=VIEWER_REQUESTS,
                    ms_per_request=float(np.mean(times[1:])),
                    ms_first=times[0],
                    render_ms=cuda_ms(t, lambda: self.render.render(
                        cam, st, bg), reps=10),
                    overflow=int(direct["overflow"]),
                    pair_capacity=self.rasterize.default_pair_capacity(
                        st.capacity),
                    plain_max_level_diff=plain_diff,
                    launches={n: launches[n] for n in FORWARD})
        finally:
            gui.close()
        stats = gui.stats
        assert stats["errors"] == 0 and stats["renders"] == len(views) * (
            VIEWER_REQUESTS), stats
        assert stats["overflowed_views"] == 0, stats
        del full
        cli = self.viewer_cli(scene.test_cameras[0])
        emit("viewer", ok=True, views=views, stats=stats, cli=cli,
             seconds=time.perf_counter() - t_phase, nvidia_smi=self.smi)

    def viewer_cli(self, cam) -> dict:
        """The train CLI on train_cli's scene with the viewer on a free
        port and a client that holds training, then lets it go on."""
        T = self.testing
        port = T.free_port_below_ephemeral()
        client = Client(port, T.camera_message(cam))
        client.start()
        with tempfile.TemporaryDirectory() as tmp:
            run = self.train_cli(
                ["-s", self.cli_scene, "-m", os.path.join(tmp, "model"),
                 "--iterations", str(VIEWER_CLI_ITERS), "--test_iterations",
                 str(VIEWER_CLI_ITERS), "--save_iterations",
                 str(VIEWER_CLI_ITERS), "--port", str(port)], viewer=True)
        session = client.result()
        return viewer_run(run, session, port)

    # --- the depth model's training half ------------------------------------

    def phase_depth_train(self):
        """The depth trainer on the card: the repo's configuration against
        the CPU and its plain attention against the fused one, then
        DEPTH_RUN_r05's recipe through depth_train_proof, its step's
        operation bound, and a checkpoint written and reloaded."""
        t, t_phase = self.torch, time.perf_counter()
        from torch.utils.flop_counter import FlopCounterMode

        from priordepth_gaussiansplatting_torch import (
            depth_train_proof as proof)
        from priordepth_gaussiansplatting_torch.depth import (config, layers,
                                                              trainer)
        cfg = config.get_config("depth", "train", "nyu",
                                max_depth=proof.MAX_DEPTH)
        opt = trainer.DepthTrainerConfig(lr=3e-4, epochs=1,
                                         steps_per_epoch=400,
                                         max_depth=proof.MAX_DEPTH)

        def steps(device, fused):
            """(losses, {name: array}) of DEPTH_CHECK_STEPS steps from
            DEPTH_SEED's weights on `device`, the attention fused or in its
            plain form."""
            model = config.build_model(
                cfg, device=device,
                generator=t.Generator().manual_seed(DEPTH_SEED))
            layers.use_fused_attention(model, fused)
            tr = trainer.DepthTrainer(model, opt, device=device)
            out = [tr.train_step(*batch) for _ in range(DEPTH_CHECK_STEPS)]
            return out, {n: p.detach().cpu().numpy()
                         for n, p in model.named_parameters()}
        imgs, depths = proof.make_rgbd(DEPTH_CHECK, DEPTH_CHECK_SIDE)
        masks = np.isfinite(depths) & (depths > 0.05) & (depths
                                                         < proof.MAX_DEPTH)
        batch = (imgs, np.where(masks, depths, 1.0), masks)
        before = {n: p.detach().numpy() for n, p in config.build_model(
            cfg, device="cpu", generator=t.Generator().manual_seed(
                DEPTH_SEED)).named_parameters()}
        # The Adam tolerance in units of lr·k, lr the configured rate; the
        # share within 1e-3 of the rates the k updates applied (OneCycle's
        # first, 1/25 of it) is printed beside it.
        lr_k = 3e-4 * DEPTH_CHECK_STEPS
        applied = sum(trainer.onecycle_lr(s, 400, 3e-4)
                      for s in range(DEPTH_CHECK_STEPS))
        runs, secs = {}, {}
        for label, device, fused in (("card", self.dev, True),
                                     ("card_plain", self.dev, False),
                                     ("cpu", t.device("cpu"), True)):
            t0 = time.perf_counter()
            runs[label] = steps(device, fused)
            secs[label] = time.perf_counter() - t0
        check = {}
        for label, other in (("card_vs_cpu", "cpu"),
                             ("fused_vs_plain", "card_plain")):
            (la, pa), (lb, pb) = runs["card"], runs[other]
            rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
            share, worst = self.testing.adam_agreement(pa, pb, before, lr_k)
            assert np.isfinite(la).all() and rel <= DEPTH_LOSS_RTOL, (
                label, la, lb)
            assert share >= 0.999 and worst <= 2, (label, share, worst)
            share_applied, worst_applied = self.testing.adam_agreement(
                pa, pb, before, applied)
            check[label] = dict(loss_rel=rel, params_within_share=share,
                                params_worst_in_lr=worst,
                                applied_rates_share=share_applied,
                                applied_rates_worst=worst_applied)
        # DEPTH_RUN_r05's recipe at full width.
        args = proof.parse_args(DEPTH_R05 + ["--out_dir", os.path.join(
            self.work, "depth_run")])
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = proof.run(args, self.dev)
        t.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = t.cuda.max_memory_allocated() / 2 ** 30
        pay, tr = res["payload"], res["trainer"]
        losses = np.asarray(pay["losses"])
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        assert np.isfinite(losses).all() and last <= 0.5 * first, (first,
                                                                    last)
        test_img, test_d, test_m = res["test"]
        x = t.from_numpy(test_img[:args.batch]).to(self.dev)
        with FlopCounterMode(display=False) as flops:
            loss = tr.loss(x, t.from_numpy(test_d[:args.batch]),
                           t.from_numpy(test_m[:args.batch]))
            t.autograd.grad(loss, tr.params)
        step_flop = flops.get_total_flops()
        # A checkpoint, reloaded into a model drawn from another seed,
        # predicts the same held-out depth.
        tr.cfg.checkpoint_dir = os.path.join(self.work, "depth_ck")
        tr.save_checkpoint("r05.pkl")
        fresh = trainer.DepthTrainer(config.build_model(
            res["config"], generator=t.Generator().manual_seed(1),
            device=self.dev), tr.cfg, device=self.dev)
        fresh.load_checkpoint(os.path.join(tr.cfg.checkpoint_dir,
                                           "r05.pkl"))
        with t.inference_mode():
            x = t.from_numpy(test_img).to(self.dev).permute(0, 3, 1, 2)
            again = fresh.model(x)["metric_depth"].cpu().numpy()
        again = np.clip(again, tr.cfg.min_depth, proof.MAX_DEPTH)
        reload_diff = float(np.abs(again - res["pred"]).max())
        assert reload_diff <= 1e-6 * float(np.abs(res["pred"]).max()), (
            reload_diff)
        # Where a step's time goes: three more steps (on held-out views,
        # after their evaluation) under the profiler.
        held = [t.from_numpy(a[:args.batch]).to(self.dev)
                for a in res["test"]]
        prof = self.profile(lambda _: tr.train_step(*held), [0, 1, 2])
        ev = pay["eval"]
        emit("depth_train", ok=True,
             check=dict(config={k: cfg[k] for k in (
                 "embed_dim", "encoder_depth", "n_bins", "max_depth")},
                 side=DEPTH_CHECK_SIDE, batch=DEPTH_CHECK,
                 steps=DEPTH_CHECK_STEPS, losses={k: v[0] for k, v in
                                                  runs.items()},
                 seconds=secs, **check),
             r05=dict(args=DEPTH_R05, n_params=pay["n_params"],
                      steps_per_s=pay["steps_per_s"], wall_s=pay["wall_s"],
                      ms_per_step=pay["ms_per_step"],
                      step_flop=step_flop,
                      bound_ms=step_flop / CARD_F32_OPS_PER_S * 1e3,
                      peak_mem_gib=peak, loss_0=float(losses[0]),
                      loss_last=float(losses[-1]), first20_mean=first,
                      last20_mean=last, a1=ev["a1"], abs_rel=ev["abs_rel"],
                      rmse=ev["rmse"], eval=ev, run_s=run_s,
                      reload_max_abs_diff=reload_diff, profile=prof),
             seconds=time.perf_counter() - t_phase, nvidia_smi=self.smi)

    def kernels_line(self):
        res = self.results
        rows = []
        for name, (kid, source, replaces) in KERNELS.items():
            rows.append({
                "name": name, "id": kid, "route": "cuda",
                "source": f"priordepth_gaussiansplatting_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": res["launches"][name],
                "max_abs_err": res["errs"][name], "ms": res["ms"][name],
                "plain_ms": res["plain_ms"][name],
                "bound_ms": res["bound_ms"][name],
                "bound_by": res["bound_by"][name],
                "library_ms": res["library_ms"][name],
            })
        print(json.dumps({"kernels": rows}), flush=True)


@contextlib.contextmanager
def card_memory_peak():
    """The card's memory in use (every process's, the smoke's own cache
    included), sampled by nvidia-smi every 200 ms while the block runs:
    yields a dict that holds ``peak_mib`` afterwards."""
    res = {}
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield res
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
        res["peak_mib"] = max((int(v) for v in out.split()
                               if v.strip().isdigit()), default=None)


def viewer_run(run: dict, session: dict, port: int) -> dict:
    """What a train CLI run with the viewer and `viewer_session`'s client
    shows: every request rendered (through K1, K5a and K2, once each), none
    failed, the renders' launches kept out of the steps'."""
    v = run["viewer"]
    n = session["requests"]
    assert f"network viewer on 127.0.0.1:{port}" in run["out"]
    assert (v["renders"], v["errors"], v["overflowed_views"]) == (n, 0, 0), v
    assert v["launches"] == dict.fromkeys(FORWARD, n), v
    return dict(session, iterations=run["iterations_run"],
                wall_s=run["wall_s"], viewer=v,
                step_launches=run["step_launches"], skipped=run["skipped"])


def prune_on_cpu(ck: str, scene: str) -> dict:
    """Phase thesis's prune loop on the CPU, in a process of its own (the
    card's loops run meanwhile), leaving two cores to the parent."""
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    return Smoke().prune_run(ck, scene, torch.device("cpu"))


def multi_rank(rank: int, world: int) -> dict:
    """One rank of ``--ranks``, on card `rank` (spawn's target)."""
    import torch
    smoke = Smoke()
    smoke.dev = torch.device("cuda", rank)
    out = smoke.multi_runs(world)
    out["card"] = torch.cuda.get_device_name(rank)
    return out


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--ranks", type=int, default=1,
        help="with N > 1, run only the multi-rank phases: N processes, "
             "one per card, in an NCCL group, then the train CLI over N "
             "cards (needs N cards)")
    parser.add_argument(
        "--phases", nargs="+", choices=CLI_PHASES + RANK_PHASES,
        help="run only phase device and these phases of the CLIs, in their "
             "order (train_cli first when one uses its scene and model); "
             "no kernels line. With --ranks, only these of its phases")
    parser.add_argument(
        "--turns", metavar="DIR",
        help="run only the turns phase: K7 and K1 in turns against those "
             "built from DIR's priordepth_gaussiansplatting_torch/csrc/")
    args = parser.parse_args(argv)
    wrong = set(args.phases or ()) - set(RANK_PHASES if args.ranks > 1
                                         else CLI_PHASES)
    if wrong:
        parser.error(f"phases {sorted(wrong)} do not run with --ranks "
                     f"{args.ranks}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from priordepth_gaussiansplatting_torch import kernels
    from priordepth_gaussiansplatting_torch.kernels import build
    t0 = time.perf_counter()
    build_seconds = build.build(kernels.KERNELS)
    build_wall = time.perf_counter() - t0
    if args.ranks > 1:
        return main_multi(args.ranks, build_wall,
                          args.phases or RANK_PHASES)
    smoke = Smoke()
    if args.turns:
        smoke.phase_turns(args.turns)
        return finish(smoke.smi)
    if args.phases:
        with tempfile.TemporaryDirectory() as work:
            smoke.work = work
            smoke.phase_device(build_seconds, build_wall)
            scene = set(args.phases) & set(CLI_PHASES[1:-1])
            for name in CLI_PHASES:
                if name in args.phases or (name == "train_cli" and scene):
                    getattr(smoke, f"phase_{name}")()
        return finish(smoke.smi)
    with tempfile.TemporaryDirectory() as work:
        smoke.work = work
        smoke.phase_device(build_seconds, build_wall)
        smoke.phase_mid()
        smoke.phase_full()
        smoke.phase_train()
        smoke.phase_train_mid()
        smoke.phase_bands()
        smoke.phase_sharded()
        smoke.phase_cli()
        smoke.phase_bin()
        smoke.phase_probe()
        smoke.phase_train_cli()
        smoke.phase_mesh_train()
        smoke.phase_thesis()
        smoke.phase_metrics()
        smoke.phase_depth()
        smoke.phase_depth_chain()
        smoke.phase_chain()
        smoke.phase_viewer()
        smoke.phase_depth_train()
    smoke.kernels_line()
    return finish(smoke.smi)


def finish(smi: str) -> int:
    """The card's name and power limit, then the last line."""
    import torch
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_multi(ranks: int, build_wall: float, phases=RANK_PHASES) -> int:
    """``--ranks N``: the sharded step, the train CLI and the depth
    trainer over N cards, one rank each (`phases`: which of them)."""
    import torch
    from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
    if torch.cuda.device_count() < ranks:
        print(f"chip_smoke: --ranks {ranks} needs {ranks} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    if "multi_rank" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            per_rank = pmesh.spawn(ranks, multi_rank, backend="nccl",
                                   store_dir=tmp, timeout=900)
            wall = time.perf_counter() - t0
        emit("multi_rank", ok=True, ranks=ranks, n=FULL_N, width=FULL_W,
             height=FULL_H, steps=TRAIN_STEPS, build_wall_s=build_wall,
             spawn_wall_s=wall, nvidia_smi=smi.splitlines(),
             rank0=per_rank[0],
             step_ms_by_rank={label: [r["grids"][label]["step_ms"]
                                      for r in per_rank]
                              for label in per_rank[0]["grids"]},
             single_step_ms_by_rank=[r["single_step_ms"] for r in per_rank])
    if "multi_cli" in phases:
        multi_cli(ranks)
    if "depth_dp" in phases:
        depth_dp(ranks, smi)
    return finish(smi)


def depth_dp_run(rank: int, world: int, data: str,
                 device: str = "cuda") -> dict:
    """The depth trainer with the repo's configuration from DEPTH_SEED's
    weights on card `rank` (or on the CPU, for a rehearsal over gloo),
    this rank's rows of each global batch (the group, if any, is the
    world): DP_STEPS checked steps, then DP_STEPS timed ones. In the
    checked steps of a group, rank 0 also takes the loss and gradients of
    the whole global batch alone at the same parameters: the group's must
    agree (loss within DEPTH_LOSS_RTOL, gradients within GRAD_ATOL
    max|g| + GRAD_RTOL |g|)."""
    import torch
    from priordepth_gaussiansplatting_torch.depth import config, trainer
    cuda = device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device(device)
    with np.load(data) as f:
        imgs, depths, masks, draws = (f["imgs"], f["depths"], f["masks"],
                                      f["draws"])
    cfg = config.get_config("depth", "train", "nyu", max_depth=8.0)
    tr = trainer.DepthTrainer(config.build_model(
        cfg, generator=torch.Generator().manual_seed(DEPTH_SEED),
        device=dev), trainer.DepthTrainerConfig(
            lr=3e-4, epochs=1, steps_per_epoch=DP_SCHEDULE, max_depth=8.0),
        device=dev)
    data = [torch.from_numpy(a).to(dev) for a in (imgs, depths, masks)]
    rows = slice(rank * DP_BATCH // world, (rank + 1) * DP_BATCH // world)
    checked = rank == 0 and world > 1

    def alone(x, d, m):  # the trainer's loss, this rank alone
        loss = trainer.depth_loss(tr.model, tr.cfg, x.permute(0, 3, 1, 2),
                                  d, m)
        return float(loss), torch.autograd.grad(loss, tr.params)

    out = dict(losses=[], loss_rel=[], grad_worst=[])
    for idx in draws:
        full = [a[torch.from_numpy(idx).to(dev)] for a in data]
        if checked:
            ref_loss, ref_grads = alone(*full)
        loss, grads = tr.gradients(*(a[rows] for a in full))
        out["losses"].append(float(loss))
        if checked:
            scale = max(float(g.abs().max()) for g in ref_grads)
            out["loss_rel"].append(abs(float(loss) - ref_loss) / ref_loss)
            out["grad_worst"].append(max(
                float(((a - b).abs() - GRAD_RTOL * b.abs()).max())
                for a, b in zip(grads, ref_grads)) / scale)
        tr.apply_gradients(grads)
        tr.step_count += 1
    if checked:
        assert max(out["loss_rel"]) <= DEPTH_LOSS_RTOL, out["loss_rel"]
        assert max(out["grad_worst"]) <= GRAD_ATOL, out["grad_worst"]
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for idx in draws:
        idx = torch.from_numpy(idx[rows]).to(dev)
        tr.train_step(*(a[idx] for a in data))
    secs = time.perf_counter() - t0
    out.update(steps_per_s=len(draws) / secs,
               ms_per_step=1e3 * secs / len(draws),
               peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if cuda else None))
    return out


def depth_dp(ranks: int, smi: str, device: str = "cuda") -> None:
    """Phase depth_dp of ``--ranks N``: the depth trainer over N cards
    (NCCL), 8 / N samples a rank. Every rank's losses the same; at every
    step rank 0's loss and averaged gradients those of the global batch
    on one rank at the same parameters; then a run on one rank from the
    same weights over the same batches: its first loss within
    DEPTH_LOSS_RTOL, the later ones printed beside the group's (rounding
    differences grow along a trajectory); steps/s of each."""
    from priordepth_gaussiansplatting_torch import depth_train_proof as proof
    from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
    t_phase = time.perf_counter()
    imgs, depths = proof.make_rgbd(DP_VIEWS, DP_SIDE)
    masks = np.isfinite(depths) & (depths > 0.05) & (depths < 8.0)
    rng = np.random.RandomState(0)
    draws = np.stack([rng.choice(DP_VIEWS, DP_BATCH, replace=False)
                      for _ in range(DP_STEPS)])
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "rgbd.npz")
        np.savez(data, imgs=imgs, depths=np.where(masks, depths, 1.0),
                 masks=masks, draws=draws)
        per_rank = pmesh.spawn(ranks, depth_dp_run, data, device,
                               backend=pmesh.backend_for(device),
                               store_dir=tmp, timeout=600)
        single = depth_dp_run(0, 1, data, device)
    for r in per_rank:
        assert r["losses"] == per_rank[0]["losses"], r["losses"]
    many, one = per_rank[0]["losses"], single["losses"]
    drift = [abs(a - b) / abs(b) for a, b in zip(many, one)]
    assert np.isfinite(many).all() and drift[0] <= DEPTH_LOSS_RTOL, drift
    emit("depth_dp", ok=True, ranks=ranks, side=DP_SIDE, views=DP_VIEWS,
         global_batch=DP_BATCH, steps=DP_STEPS, schedule=DP_SCHEDULE,
         losses=many, lockstep_loss_rel_max=max(per_rank[0]["loss_rel"]),
         lockstep_grad_worst_max=max(per_rank[0]["grad_worst"]),
         single_rank_losses=one, single_rank_drift=drift,
         steps_per_s={"1": single["steps_per_s"],
                      str(ranks): per_rank[0]["steps_per_s"]},
         ms_per_step={"1": single["ms_per_step"],
                      str(ranks): [r["ms_per_step"] for r in per_rank]},
         peak_mem_gib={"1": single["peak_mem_gib"],
                       str(ranks): per_rank[0]["peak_mem_gib"]},
         seconds=time.perf_counter() - t_phase, nvidia_smi=smi.splitlines())


def multi_events(run: dict, ranks: int) -> list:
    """The thesis events of a train CLI run over `ranks` ranks: each at its
    iteration, the same active count on every rank (rank 0 prints the
    counts it gathered), six rows injected, the prune's renders through
    K1, K5a and K2 on rank 0."""
    inj, prn = run["events"]
    assert (inj["iteration"], prn["iteration"]) == (MULTI_INJECT,
                                                    MULTI_PRUNE), run
    for e in (inj, prn):
        assert e["n_active_by_rank"] == [e["n_active"]] * ranks, e
        assert f"active rows by rank: {e['n_active_by_rank']}" in run["out"]
    assert inj["n_active"] == inj["n_active_before"] + 6, inj
    assert prn["overflowed_views"] == 0 and prn["deleted"] >= 1, prn
    assert prn["launches"] == dict.fromkeys(FORWARD,
                                            len(prn["history"])), prn
    return [{k: e.get(k) for k in ("event", "iteration", "n_active_before",
                                   "n_active", "n_active_by_rank", "deleted",
                                   "views", "seconds")} for e in (inj, prn)]


def multi_cli(ranks: int) -> None:
    """Phase multi_cli of ``--ranks N``: the train CLI itself on N cards
    (it starts its N ranks) on train_cli's scene, for MULTI_CLI_ITERS
    iterations over the grids (1, N) with tile bands and, for N = 4,
    (2, 2); then a single-rank checkpoint restored over (1, N), whose
    shards' active rows must differ by at most one."""
    smoke = Smoke()
    size, views = CLI_SCENE
    iters, check = MULTI_CLI_ITERS, MULTI_CLI_ITERS // 2
    grids = [("1x%d_bands" % ranks, ["--n_gauss", str(ranks), "--tile_shard"],
              TILE_STEP)]
    events = ["-d", "depths", "--noise_injection_iter", str(MULTI_INJECT),
              "--floating_prune_iter", str(MULTI_PRUNE)]
    if ranks % 2 == 0 and ranks > 2:
        grids.append(("2x%d" % (ranks // 2),
                      ["--n_data", "2", "--n_gauss", str(ranks // 2)]
                      + events, STEP))
        # The same run with the viewer on and a client (its requests come
        # in the first iterations; the broadcast of one int per iteration
        # stays).
        grids.append(("2x%d_viewer" % (ranks // 2),
                      ["--n_data", "2", "--n_gauss", str(ranks // 2)]
                      + events, STEP))
    out = {}
    with tempfile.TemporaryDirectory() as work:
        scene = os.path.join(work, "scene")
        smoke.run_cmd([sys.executable, "-m", PORT + "make_synthetic_scene",
                       scene, str(size), str(views)], 600)
        smoke.testing.write_depth_priors(scene, size, views)
        from priordepth_gaussiansplatting_torch.data.dataset import Scene
        message = smoke.testing.camera_message(Scene(
            scene, eval_split=True, shuffle=False,
            device="cpu").test_cameras[0])
        for label, flags, path in grids:
            model = os.path.join(work, label)
            viewer = label.endswith("_viewer")
            if viewer:
                port = smoke.testing.free_port_below_ephemeral()
                flags = flags + ["--port", str(port)]
                client = Client(port, message)
                client.start()
            run = smoke.train_cli(
                ["-s", scene, "-m", model, "--iterations", str(iters),
                 "--test_iterations", str(check), str(iters),
                 "--save_iterations", str(iters)] + flags, path=path,
                viewer=viewer)
            assert run["iterations_run"] == iters
            assert run["out"].count("Training complete: ") == 1
            assert "Multi-chip mesh: " in run["out"]
            psnr, train_psnr, steady = run_readings(
                read_events(model), check + 50, iters - 50)
            assert psnr[iters] > psnr[check], (label, psnr)
            out[label] = dict(it_per_s_between_evals=steady,
                              wall_s=run["wall_s"], test_psnr=psnr,
                              train_psnr=train_psnr,
                              n_active=run["n_active"],
                              step_launches=run["step_launches"])
            if "--floating_prune_iter" in flags:
                out[label]["events"] = multi_events(run, ranks)
            if viewer:
                out[label]["viewer"] = viewer_run(run, client.result(), port)
                plain = out[label.replace("_viewer", "")]
                out[label]["it_per_s_vs_without_viewer"] = (
                    steady / plain["it_per_s_between_evals"])
        single = os.path.join(work, "single")
        smoke.train_cli(["-s", scene, "-m", single, "--iterations",
                         str(check), "--test_iterations", str(check),
                         "--save_iterations", str(check),
                         "--checkpoint_iterations", str(check)])
        run = smoke.train_cli(
            ["-s", scene, "-m", os.path.join(work, "restored"),
             "--n_gauss", str(ranks), "--iterations", str(check + 20),
             "--test_iterations", str(check + 20), "--save_iterations",
             str(check + 20), "--start_checkpoint",
             os.path.join(single, f"chkpnt{check}.pkl")])
        line = next(ln for ln in run["out"].splitlines()
                    if ln.startswith("Restored checkpoint at iteration"))
        counts = json.loads(line[line.index("["):line.index("]") + 1])
        assert len(counts) == ranks and max(counts) - min(counts) <= 1, line
        out["restored"] = dict(active_per_shard=counts,
                               iterations_run=run["iterations_run"],
                               skipped=run["skipped"])
    emit("multi_cli", ok=True, ranks=ranks, scene=dict(size=size,
                                                       views=views),
         iterations=iters, **out)


if __name__ == "__main__":
    sys.exit(main())
