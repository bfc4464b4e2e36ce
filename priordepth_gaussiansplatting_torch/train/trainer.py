"""The training loop (counterpart of the JAX package's ``train/trainer.py``;
reference ``train.py:64-342``), on one rank or on each rank of a mesh.

Each iteration is one ``train/step.py::make_train_step`` step on the card,
or with a mesh (``parallel/mesh.py::Mesh``) one step of
``parallel/integrate.py::make_sharded_fns`` on this rank's shard, fed one
camera per data rank. The loop keeps on the host what must be there: the
camera order, the SH degree, densification and opacity resets, the pair
capacity, evaluation, snapshots, checkpoints and logging. A step's metrics
stay on the card as one (6,) vector and are copied to the host 50
iterations at a time, never per step: the step is bound by its kernel
launches, and a per-step read would stall the host that launches them.

On a mesh every rank runs its own Trainer and takes the same host
decisions in the same order (the camera order, the schedules, the densify
seeds, the pair-capacity ladder and the skip guard act on metrics that the
step reduces over the grid), so every rank makes the same collectives.
Evaluation, snapshots and checkpoints gather the whole state on every
rank; rank 0 alone writes files and prints progress.

The PriorDepth thesis events (``train/prune.py``) run where the JAX
trainer runs them, after the densify round and the opacity reset of their
iteration: the noise injection at ``noise_injection_iter`` and the
floating-object prune loop at ``floating_prune_iter``. On a mesh every rank
gathers the store and takes the event's draws; rank 0 runs the event and
broadcasts the store, every rank places its shard again, and the ranks'
active counts must agree. The kernel launches of the events, like those of
the evaluations, are left out of the steps' count.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.cameras import Camera
from ..device import launch_counts, resolve_device
from ..models import gaussians as gm
from ..ops import rasterize as raster_ops
from ..ops import render as render_ops
from ..parallel import integrate as par
from ..parallel import step as pstep
from ..parallel.mesh import GAUSS_AXIS, all_gather_rows, gather_world, psum
from ..utils.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                            save_cfg_args)
from ..utils.logging import MetricsLogger
from . import checkpoint as ckpt
from . import optim
from . import prune as prune_lib
from . import step as step_lib

# The per-step metrics vector, in the JAX trainer's order.
METRICS = ("loss", "l1", "n_active", "num_pairs", "overflow", "skipped")


class Trainer:
    """One scene trained on one device (the card unless the caller names
    the CPU), or this rank's part of a run over `mesh`
    (``parallel/mesh.py::Mesh``; the device defaults to the mesh's), with
    ``tile_shard`` splitting the compositor's tiles into bands over the
    gauss ranks. ``noise_source``, when set, returns the (2, rows, 3) split
    draws of the next densify round (rows: the store's, or on a mesh this
    rank's shard's) in place of the trainer's generator, and
    ``inject_source`` the draws of the noise injection
    (``train/prune.py::noise_draws``'s dict); the tests feed both the JAX
    trainer's draws."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
                 pipe_cfg: PipelineConfig, scene, seed: int = 0,
                 quiet: bool = False, init_capacity: Optional[int] = None,
                 pin_pair_capacity: Optional[int] = None, device=None,
                 mesh=None, tile_shard: bool = False):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.pipe_cfg = pipe_cfg
        self.scene = scene
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        self.mesh = mesh
        self.tile_shard = tile_shard
        self.n_data = mesh.n_data if mesh is not None else 1
        self.n_gauss = mesh.n_gauss if mesh is not None else 1
        # Rank 0 alone writes files and prints progress.
        self.writer = mesh is None or mesh.rank == 0
        self.quiet = quiet or not self.writer
        # The camera order comes from Python's generator, as in the JAX
        # trainer; random backgrounds and split draws (on a mesh: the
        # densify seeds) from one generator on the device.
        self.rng = random.Random(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.noise_source: Optional[Callable[[], torch.Tensor]] = None
        self.inject_source: Optional[Callable[[], dict]] = None

        xyz, colors, _ = scene.point_cloud()
        capacity = init_capacity
        if self.n_gauss > 1:
            # Room for growth in every shard, and equal shards.
            if capacity is None:
                n_pts = int(np.asarray(xyz).shape[0])
                capacity = max(2 ** int(np.ceil(np.log2(max(n_pts * 4,
                                                            1024)))),
                               1024, self.n_gauss)
            capacity = -(-capacity // self.n_gauss) * self.n_gauss
        self.state = gm.create_from_points(
            np.asarray(xyz), np.asarray(colors),
            num_images=len(scene.train_cameras), capacity=capacity,
            max_sh_degree=model_cfg.sh_degree,
            spatial_lr_scale=scene.cameras_extent, device=self.device)
        self.opt_state = optim.init_adam(self.state.params)
        if mesh is not None:
            # Every rank builds the same global store; interleaving spreads
            # the live rows over the shards before each rank keeps its own.
            self.state, self.opt_state = par.interleave_rows(
                self.state, self.opt_state, self.n_gauss)
            self.state, self.opt_state = par.place_sharded(
                self.state, self.opt_state, mesh)
            # Cameras of mixed sizes or intrinsics are padded onto one
            # canvas, so that every batch has the same shape.
            keys = {(c.height, c.width, c.fovx, c.fovy)
                    for c in scene.train_cameras}
            self._batch_hw = ((max(c.height for c in scene.train_cameras),
                               max(c.width for c in scene.train_cameras))
                              if len(keys) > 1 else None)
        # A pinned pair capacity switches the adaptive ladder off.
        self._pin_pair_capacity = pin_pair_capacity
        self.pair_capacity: Optional[int] = pin_pair_capacity
        self.fns = self._make_fns(self.pair_capacity)
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if model_cfg.white_background
            else [0.0, 0.0, 0.0], device=self.device)
        self.iteration = 0
        self._camera_stack: List[Camera] = []
        self.ema_loss = 0.0
        self.history: List[dict] = []
        self._gt_logged = False
        self.logger = MetricsLogger(model_cfg.model_path if self.writer
                                    else "")
        if model_cfg.model_path and self.writer:
            save_cfg_args(model_cfg.model_path, model_cfg)
        # The consecutive dropped-update guard (see _observe_skip).
        self.consecutive_skips = 0
        self.total_skips = 0
        self.max_consecutive_skips = 25
        self.nonfinite_losses = 0
        # One dict per thesis event run (see inject_noise).
        self.events: List[dict] = []

    def _make_fns(self, pair_capacity: Optional[int] = None):
        if self.mesh is not None:
            return par.make_sharded_fns(
                self.opt_cfg, self.pipe_cfg, self.mesh,
                use_trained_exp=self.model_cfg.train_test_exp,
                tile_shard=self.tile_shard, pair_capacity=pair_capacity)
        return step_lib.make_train_step(
            self.opt_cfg, self.pipe_cfg,
            use_trained_exp=self.model_cfg.train_test_exp,
            pair_capacity=pair_capacity)

    # ------------------------------------------------------------- loop
    def pick_camera(self) -> Camera:
        """Pop from a stack reshuffled when empty (``train.py:129-135``)."""
        if not self._camera_stack:
            self._camera_stack = list(self.scene.train_cameras)
            self.rng.shuffle(self._camera_stack)
        return self._camera_stack.pop()

    def pick_camera_batch(self) -> list:
        """One camera per data rank, in the order of the shared stack,
        stacked for the sharded step (padded when sizes differ)."""
        cams = [self.pick_camera() for _ in range(self.n_data)]
        if self._batch_hw is not None:
            return pstep.pad_camera_batch(cams, target_hw=self._batch_hw)
        return pstep.stack_cameras(cams)

    def restore(self, path: str) -> None:
        """Load a checkpoint of either package. On a mesh with n_gauss > 1
        its active rows are compacted and interleaved first, so that the
        shards come out balanced whether the checkpoint was written by a
        single rank (live rows at the front) or by a sharded run (with
        densify holes)."""
        state, opt_state, self.iteration = ckpt.load_checkpoint(
            path, device=self.device)
        if self.mesh is not None:
            if self.n_gauss > 1:
                state, opt_state = par.pad_capacity_to_multiple(
                    state, opt_state, self.n_gauss)
                state, opt_state = par.compact_rows(state, opt_state)
                state, opt_state = par.interleave_rows(state, opt_state,
                                                       self.n_gauss)
            state, opt_state = par.place_sharded(state, opt_state, self.mesh)
        self.state, self.opt_state = state, opt_state
        shards = ""
        if self.mesh is not None:
            counts = all_gather_rows(state.num_active.reshape(1), self.mesh,
                                     GAUSS_AXIS)
            shards = f" (active rows per shard: {counts.tolist()})"
        if self.writer:
            print(f"Restored checkpoint at iteration {self.iteration}"
                  f"{shards}")

    @property
    def capacity(self) -> int:
        """Rows of the whole store (on a mesh, over every shard)."""
        return self.state.capacity * self.n_gauss

    def num_active(self) -> int:
        """Active rows of the whole store (on a mesh a collective: every
        rank calls it)."""
        if self.mesh is None:
            return int(self.state.num_active)
        return int(psum(self.state.num_active, self.mesh, GAUSS_AXIS))

    def gathered(self):
        """(state, opt_state) of the whole store: on a mesh gathered from
        the shards on every rank (a collective)."""
        if self.mesh is None:
            return self.state, self.opt_state
        return par.gather_sharded(self.state, self.opt_state, self.mesh)

    def _grow(self):
        if self.mesh is not None:
            return par.grow_sharded(self.state, self.opt_state, self.mesh)
        return ckpt.maybe_grow(self.state, self.opt_state)

    def _densify_draws(self) -> dict:
        """Where a densify round's split draws come from: on one rank the
        generator itself; on a mesh a seed drawn from it, the same on every
        rank, into which each gauss rank folds its own index."""
        if self.mesh is None:
            return {"generator": self.generator}
        return {"seed": int(torch.randint(2 ** 31 - 1, (),
                                          generator=self.generator,
                                          device=self.device))}

    def _metrics_vector(self, metrics: dict) -> torch.Tensor:
        zero = torch.zeros((), device=self.device)
        return torch.stack([metrics.get(k, zero).to(torch.float32)
                            for k in METRICS])

    def train(self, iterations: Optional[int] = None,
              test_iterations=(7000, 30000), save_iterations=(7000, 30000),
              checkpoint_iterations=(), on_iteration=None) -> dict:
        opt = self.opt_cfg
        total = iterations if iterations is not None else opt.iterations
        first = self.iteration + 1
        test_iterations = set(test_iterations)
        save_iterations = set(save_iterations)
        checkpoint_iterations = set(checkpoint_iterations)
        pending = []  # (iteration, (6,) metrics on the device)
        # The kernel launches of the steps: those of the whole run, less
        # those of the reports and the events.
        base = launch_counts()
        t_start = time.time()
        for it in range(first, total + 1):
            self.iteration = it
            # SH degree bump every 1000 iterations (``train.py:126-127``).
            if it % 1000 == 0:
                self.state = self.state.oneup_sh_degree()

            cam = (self.pick_camera_batch() if self.mesh is not None
                   else self.pick_camera())
            self.state, self.opt_state, metrics = self.fns.step(
                self.state, self.opt_state, cam, it, self.generator, self.bg)

            # Densification schedule (``train.py:311-326``).
            if it < opt.densify_until_iter:
                if (it > opt.densify_from_iter
                        and it % opt.densification_interval == 0):
                    noise = (self.noise_source() if self.noise_source
                             else None)
                    self.state, self.opt_state, _ = self.fns.densify(
                        self.state, self.opt_state,
                        use_size_threshold=it > opt.opacity_reset_interval,
                        noise=noise, **self._densify_draws())
                    self.state, self.opt_state, grew = self._grow()
                    if grew and not self.quiet:
                        print(f"[it {it}] capacity grown to "
                              f"{self.capacity}")
                if (it % opt.opacity_reset_interval == 0
                        or (self.model_cfg.white_background
                            and it == opt.densify_from_iter)):
                    self.state, self.opt_state = self.fns.reset_opacity(
                        self.state, self.opt_state)

            # PriorDepth thesis events (train.py:193-291).
            if opt.noise_injection_iter and it == opt.noise_injection_iter:
                self._aside(base, self.inject_noise)
            if opt.floating_prune_iter and it == opt.floating_prune_iter:
                self._aside(base, self.run_floating_prune)

            pending.append((it, self._metrics_vector(metrics)))
            if (it % 50 == 0 or it >= total or it in test_iterations
                    or it in save_iterations or it in checkpoint_iterations):
                self._drain(pending, total, t_start)

            if it in test_iterations:
                self._aside(base, self.report, it)
            if it in save_iterations and self.model_cfg.model_path:
                self.save_snapshot(it)
            if it in checkpoint_iterations and self.model_cfg.model_path:
                self.save_checkpoint(it)
            if on_iteration is not None:
                # The hook's launches (the viewer's renders) stay out of
                # the steps' count.
                self._aside(base, on_iteration, self, it, metrics)
        wall = time.time() - t_start
        return {"iterations": total, "iterations_run": total - first + 1,
                "wall_s": wall, "final_loss": self.ema_loss,
                "n_active": self.num_active(),
                "skipped": self.total_skips,
                "step_launches": {k: v - base[k]
                                  for k, v in launch_counts().items()
                                  if v != base[k]},
                "events": [e for e in self.events
                           if first <= e["iteration"] <= total]}

    @staticmethod
    def _aside(base: dict, fn, *args) -> None:
        """``fn(*args)``, whose kernel launches are added to `base` so that
        they stay out of the steps' count."""
        before = launch_counts()
        fn(*args)
        for k, v in launch_counts().items():
            base[k] += v - before[k]

    def _drain(self, pending: list, total: int, t_start: float) -> None:
        """Copy the queued metrics to the host in one transfer and act on
        them in iteration order."""
        rows = torch.stack([v for _, v in pending]).cpu().numpy()
        for (jt, _), row in zip(pending, rows):
            loss, l1 = float(row[0]), float(row[1])
            n_active, num_pairs, overflow, skipped = (int(v) for v in row[2:])
            self._observe_skip(jt, skipped, overflow, loss)
            if np.isfinite(loss):
                self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
            else:
                # A non-finite frame loss stays out of the EMA; the step
                # dropped its update.
                self.nonfinite_losses += 1
                if self.nonfinite_losses <= 3 and not self.quiet:
                    print(f"[it {jt}] WARNING: non-finite loss {loss}; "
                          f"excluded from EMA ({self.nonfinite_losses} so "
                          "far)", flush=True)
            if jt % 100 == 0:
                self._adapt_pair_capacity(num_pairs, overflow)
            if jt % 10 == 0:
                # Reference TensorBoard scalar names (train.py:402-445).
                self.logger.scalars({
                    "train_loss_patches/l1_loss": l1,
                    "train_loss_patches/total_loss": loss,
                    "total_points": n_active,
                    "iter_time": time.time() - t_start,
                    "skipped": skipped,
                }, jt)
            if not self.quiet and jt % 100 == 0:
                print(f"[it {jt}/{total}] loss {self.ema_loss:.5f} "
                      f"gaussians {n_active} "
                      f"({(time.time() - t_start):.1f}s)", flush=True)
        pending.clear()

    def _effective_pair_capacity(self) -> int:
        return (self.pair_capacity
                or raster_ops.default_pair_capacity(self.capacity))

    def _adapt_pair_capacity(self, num_pairs: int, overflow: int) -> None:
        """Size the pair lists from the observed pair count: 1.5x headroom
        on the ladder (``round_capacity``), growth on overflow, and no step
        down while the pairs fill more than half of the current rung."""
        if self._pin_pair_capacity is not None:
            if overflow > 0 and not self.quiet:
                print(f"[it {self.iteration}] WARNING: pair overflow "
                      f"{overflow} with pinned capacity "
                      f"{self._pin_pair_capacity} — step skipped; raise "
                      "--pin_pair_capacity", flush=True)
            return
        effective = self._effective_pair_capacity()
        desired = raster_ops.round_capacity(int((num_pairs + overflow) * 1.5))
        if overflow > 0:
            desired = max(desired, raster_ops.round_capacity(effective + 1))
        if desired < effective and (num_pairs + overflow) * 2.0 > effective:
            return
        if desired != effective:
            self.pair_capacity = desired
            self.fns = self._make_fns(pair_capacity=desired)
            if not self.quiet:
                print(f"[it {self.iteration}] pair capacity -> {desired} "
                      f"(pairs {num_pairs}, overflow {overflow})",
                      flush=True)

    def _observe_skip(self, it: int, skipped: int, overflow: int,
                      loss: float) -> None:
        """React to dropped updates: after ``max_consecutive_skips`` in a
        row, grow the pair capacity one rung when they overflowed, else
        abort rather than train on without updates."""
        if not skipped:
            self.consecutive_skips = 0
            return
        self.consecutive_skips += 1
        self.total_skips += 1
        if self.writer and (self.total_skips <= 5
                            or self.consecutive_skips in (5, 10, 20)):
            cause = ("pair overflow" if overflow > 0
                     else f"non-finite loss ({loss})")
            print(f"[it {it}] WARNING: update skipped ({cause}); "
                  f"{self.consecutive_skips} consecutive, "
                  f"{self.total_skips} total", flush=True)
        if self.consecutive_skips < self.max_consecutive_skips:
            return
        if overflow > 0:
            effective = self._effective_pair_capacity()
            grown = raster_ops.round_capacity(effective + 1)
            if self.writer:
                print(f"[it {it}] pair capacity auto-grown {effective} -> "
                      f"{grown} after {self.consecutive_skips} consecutive "
                      "overflow skips", flush=True)
            if self._pin_pair_capacity is not None:
                self._pin_pair_capacity = grown
            self.pair_capacity = grown
            self.fns = self._make_fns(pair_capacity=grown)
            self.consecutive_skips = 0
            return
        raise RuntimeError(
            f"[it {it}] {self.consecutive_skips} consecutive updates "
            f"dropped on non-finite loss ({loss}) — the run is not "
            "training; aborting instead of free-wheeling. Inspect with "
            "--detect_anomaly / --debug_from.")

    # ------------------------------------------------------------- eval
    def report(self, it: int) -> dict:
        """PSNR and L1 on the held-out views and the first five training
        views (``train.py:402-445``), their first five images, and the
        opacity histogram. Each view renders at the default pair capacity of
        the store, as in the JAX trainer; a view that overflows it is
        reported, and its PSNR reads low. On a mesh every rank gathers the
        store and evaluates it; rank 0 logs."""
        state, _ = self.gathered()
        out = {}
        for split, cams in (("test", self.scene.test_cameras),
                            ("train", self.scene.train_cameras[:5])):
            if not cams:
                continue
            psnrs, l1s = [], []
            for vi, cam in enumerate(cams):
                r = step_lib.eval_image(
                    cam, state, self.bg,
                    antialiasing=self.pipe_cfg.antialiasing,
                    use_trained_exp=self.model_cfg.train_test_exp,
                    backend=self.pipe_cfg.backend)
                if vi < 5:
                    name = getattr(cam, "image_name", None) or f"view_{vi}"

                    def prep(img):
                        img = torch.clamp(img, 0.0, 1.0)
                        if self.model_cfg.train_test_exp:
                            img = img[..., img.shape[-1] // 2:]
                        return img
                    self.logger.image(f"{split}_view_{name}/render",
                                      prep(r["render"]), it)
                    if cam.image is not None and not self._gt_logged:
                        self.logger.image(f"{split}_view_{name}/ground_truth",
                                          prep(cam.image), it)
                if "psnr" in r:
                    psnrs.append(float(r["psnr"]))
                    l1s.append(float(r["l1"]))
                ov = r.get("overflow")
                if ov is not None and int(ov) > 0 and not self.quiet:
                    print(f"[it {it}] WARNING: eval view {vi} overflowed "
                          f"the pair capacity by {int(ov)} — its PSNR "
                          "reads low", flush=True)
            if psnrs:
                out[split] = {"psnr": float(np.mean(psnrs)),
                              "l1": float(np.mean(l1s))}
                self.logger.scalar(f"{split}/loss_viewpoint - psnr",
                                   out[split]["psnr"], it)
                self.logger.scalar(f"{split}/loss_viewpoint - l1_loss",
                                   out[split]["l1"], it)
                if not self.quiet:
                    print(f"[it {it}] eval {split}: "
                          f"psnr {out[split]['psnr']:.2f} "
                          f"l1 {out[split]['l1']:.4f}", flush=True)
        self._gt_logged = True
        active = state.active
        self.logger.histogram("scene/opacity_histogram",
                              state.get_opacity()[active], it)
        self.logger.scalar("total_points", float(active.sum()), it)
        self.history.append({"iteration": it, **out})
        return out

    # ------------------------------------------------------------- thesis
    def inject_noise(self) -> dict:
        """The iteration-30000 robustness experiment: six floaters planted
        in free slots (``train.py:193-221``;
        ``train/prune.py::inject_noise_gaussians``). Its draws come from
        ``inject_source`` or the trainer's generator."""
        state, opt_state = self.gathered()
        before, t0 = launch_counts(), time.perf_counter()
        n_before = int(state.num_active)
        draws = (self.inject_source() if self.inject_source is not None
                 else prune_lib.noise_draws(
                     state.capacity, self.scene.cameras_extent,
                     generator=self.generator, device=self.device))
        if self._runs_events():
            state, opt_state, _ = prune_lib.inject_noise_gaussians(
                state, opt_state, self.scene.cameras_extent, draws=draws)
        event = self._settle(state, opt_state, {
            "event": "inject", "iteration": self.iteration,
            "n_active_before": n_before}, before, t0)
        if not self.quiet:
            print(f"[it {self.iteration}] injected noise gaussians "
                  f"(n_active={event['n_active']}, "
                  f"{event['n_active'] - n_before:+d}){self._ranks(event)}",
                  flush=True)
        return event

    def run_floating_prune(self) -> dict:
        """The iteration-40000 depth-prior floating-object prune loop
        (``train.py:224-291``; ``train/prune.py::prune_loop``): each view
        renders through ``ops/render.py::render`` at the store's default
        pair capacity, as in the JAX trainer, and a view that overflows it
        is reported. The loop's RandomState is seeded from the trainer's
        camera generator."""
        state, opt_state = self.gathered()
        before, t0 = launch_counts(), time.perf_counter()
        n_before = int(state.num_active)
        rng = np.random.RandomState(self.rng.randint(0, 2 ** 31))
        overflow = []

        def rfn(cam, st):
            out = render_ops.render(cam, st, self.bg,
                                    antialiasing=self.pipe_cfg.antialiasing,
                                    backend=self.pipe_cfg.backend)
            if out["overflow"] is not None:
                overflow.append(out["overflow"])
            return out["invdepth"], out["radii"]

        info = {"total_deleted": 0, "epochs": 0, "history": []}
        if self._runs_events():
            state, opt_state, info = prune_lib.prune_loop(
                state, opt_state, self.scene.train_cameras, rfn,
                self.scene.cameras_extent, rng=rng)
        over = [int(v) for v in overflow if int(v) > 0]
        event = self._settle(state, opt_state, {
            "event": "prune", "iteration": self.iteration,
            "n_active_before": n_before, "deleted": info["total_deleted"],
            "views": info["epochs"], "history": info["history"],
            "overflowed_views": len(over)}, before, t0)
        if not self.quiet:
            if over:
                print(f"[it {self.iteration}] WARNING: {len(over)} prune "
                      f"views overflowed the pair capacity (by up to "
                      f"{max(over)}) — their inverse depth reads low",
                      flush=True)
            print(f"[it {self.iteration}] floating-object prune: deleted "
                  f"{info['total_deleted']} over {info['epochs']} views "
                  f"(n_active={event['n_active']}){self._ranks(event)}",
                  flush=True)
        return event

    def _runs_events(self) -> bool:
        """Whether this rank computes a thesis event (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def _settle(self, state, opt_state, event: dict, before: dict,
                t0: float) -> dict:
        """Take the event's store: on a mesh rank 0's, broadcast to every
        rank and placed as shards again, after which every rank's active
        count must be the same. Records the event with its kernel launches
        and its seconds since `t0` (the count's read waits for the
        device)."""
        if self.mesh is not None:
            state, opt_state = par.broadcast_state(state, opt_state, src=0)
            state, opt_state = par.place_sharded(state, opt_state, self.mesh)
        self.state, self.opt_state = state, opt_state
        event["n_active"] = self.num_active()
        if self.mesh is not None:
            counts = gather_world(event["n_active"], self.mesh)
            if len(set(counts)) != 1:
                raise RuntimeError(
                    f"[it {self.iteration}] the ranks disagree after the "
                    f"{event['event']} event: active rows {counts}")
            event["n_active_by_rank"] = counts
        event["launches"] = {k: v - before[k]
                             for k, v in launch_counts().items()
                             if v != before[k]}
        event["seconds"] = time.perf_counter() - t0
        self.events.append(event)
        return event

    @staticmethod
    def _ranks(event: dict) -> str:
        counts = event.get("n_active_by_rank")
        return "" if counts is None else f"; active rows by rank: {counts}"

    def save_snapshot(self, it: int) -> None:
        state, _ = self.gathered()
        if self.writer:
            print(f"[it {it}] saving snapshot", flush=True)
            ckpt.save_model_snapshot(self.model_cfg.model_path, it, state,
                                     image_names=self.scene.exposure_ids)

    def save_checkpoint(self, it: int) -> None:
        """``<model>/chkpnt<it>.pkl``: on a mesh the gathered store, written
        once."""
        state, opt_state = self.gathered()
        if self.writer:
            ckpt.save_checkpoint(
                os.path.join(self.model_cfg.model_path, f"chkpnt{it}.pkl"),
                state, opt_state, it)
