"""The single-rank training loop (counterpart of the JAX package's
``train/trainer.py`` without the mesh; reference ``train.py:64-342``).

Each iteration is one ``train/step.py::make_train_step`` step on the card.
The loop keeps on the host what must be there: the camera order, the SH
degree, densification and opacity resets, the pair capacity, evaluation,
snapshots, checkpoints and logging. A step's metrics stay on the card as
one (6,) vector and are copied to the host 50 iterations at a time, never
per step: the step is bound by its kernel launches, and a per-step read
would stall the host that launches them.

The PriorDepth thesis events (noise injection, the floating-object prune)
are not ported yet (ROADMAP queue 1, item 4): a run whose iteration range
reaches an enabled one raises before its first step.
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
from ..utils.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                            save_cfg_args)
from ..utils.logging import MetricsLogger
from . import checkpoint as ckpt
from . import optim
from . import step as step_lib

# The per-step metrics vector, in the JAX trainer's order.
METRICS = ("loss", "l1", "n_active", "num_pairs", "overflow", "skipped")


class Trainer:
    """One scene trained on one device (the card unless the caller names
    the CPU). ``noise_source``, when set, returns the (2, capacity, 3)
    split draws of the next densify round in place of the trainer's
    generator (the tests feed it the JAX trainer's draws)."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
                 pipe_cfg: PipelineConfig, scene, seed: int = 0,
                 quiet: bool = False, init_capacity: Optional[int] = None,
                 pin_pair_capacity: Optional[int] = None, device=None):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.pipe_cfg = pipe_cfg
        self.scene = scene
        self.quiet = quiet
        self.device = resolve_device(device)
        # The camera order comes from Python's generator, as in the JAX
        # trainer; random backgrounds and split draws from one generator on
        # the device.
        self.rng = random.Random(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.noise_source: Optional[Callable[[], torch.Tensor]] = None

        xyz, colors, _ = scene.point_cloud()
        self.state = gm.create_from_points(
            np.asarray(xyz), np.asarray(colors),
            num_images=len(scene.train_cameras), capacity=init_capacity,
            max_sh_degree=model_cfg.sh_degree,
            spatial_lr_scale=scene.cameras_extent, device=self.device)
        self.opt_state = optim.init_adam(self.state.params)
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
        self.logger = MetricsLogger(model_cfg.model_path)
        if model_cfg.model_path:
            save_cfg_args(model_cfg.model_path, model_cfg)
        # The consecutive dropped-update guard (see _observe_skip).
        self.consecutive_skips = 0
        self.total_skips = 0
        self.max_consecutive_skips = 25
        self.nonfinite_losses = 0

    def _make_fns(self, pair_capacity: Optional[int] = None):
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

    def restore(self, path: str) -> None:
        self.state, self.opt_state, self.iteration = ckpt.load_checkpoint(
            path, device=self.device)
        print(f"Restored checkpoint at iteration {self.iteration}")

    def _check_thesis_events(self, first: int, last: int) -> None:
        opt = self.opt_cfg
        for name, it in (("noise_injection_iter", opt.noise_injection_iter),
                         ("floating_prune_iter", opt.floating_prune_iter)):
            if it and first <= it <= last:
                raise NotImplementedError(
                    f"{name}={it} falls in this run (iterations {first}-"
                    f"{last}), but the thesis events are not ported yet "
                    "(ROADMAP queue 1, item 4); pass --noise_injection_iter "
                    "0 --floating_prune_iter 0")

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
        self._check_thesis_events(first, total)
        test_iterations = set(test_iterations)
        save_iterations = set(save_iterations)
        checkpoint_iterations = set(checkpoint_iterations)
        pending = []  # (iteration, (6,) metrics on the device)
        # The kernel launches of the steps: those of the whole run, less
        # those of the reports.
        base = launch_counts()
        t_start = time.time()
        for it in range(first, total + 1):
            self.iteration = it
            # SH degree bump every 1000 iterations (``train.py:126-127``).
            if it % 1000 == 0:
                self.state = self.state.oneup_sh_degree()

            cam = self.pick_camera()
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
                        noise=noise, generator=self.generator)
                    self.state, self.opt_state, grew = ckpt.maybe_grow(
                        self.state, self.opt_state)
                    if grew and not self.quiet:
                        print(f"[it {it}] capacity grown to "
                              f"{self.state.capacity}")
                if (it % opt.opacity_reset_interval == 0
                        or (self.model_cfg.white_background
                            and it == opt.densify_from_iter)):
                    self.state, self.opt_state = self.fns.reset_opacity(
                        self.state, self.opt_state)

            pending.append((it, self._metrics_vector(metrics)))
            if (it % 50 == 0 or it >= total or it in test_iterations
                    or it in save_iterations or it in checkpoint_iterations):
                self._drain(pending, total, t_start)

            if it in test_iterations:
                before = launch_counts()
                self.report(it)
                for k, v in launch_counts().items():
                    base[k] += v - before[k]
            if it in save_iterations and self.model_cfg.model_path:
                self.save_snapshot(it)
            if it in checkpoint_iterations and self.model_cfg.model_path:
                ckpt.save_checkpoint(
                    os.path.join(self.model_cfg.model_path,
                                 f"chkpnt{it}.pkl"),
                    self.state, self.opt_state, it)
            if on_iteration is not None:
                on_iteration(self, it, metrics)
        wall = time.time() - t_start
        return {"iterations": total, "iterations_run": total - first + 1,
                "wall_s": wall, "final_loss": self.ema_loss,
                "n_active": int(self.state.num_active),
                "skipped": self.total_skips,
                "step_launches": {k: v - base[k]
                                  for k, v in launch_counts().items()
                                  if v != base[k]}}

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
                or raster_ops.default_pair_capacity(self.state.capacity))

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
        if self.total_skips <= 5 or self.consecutive_skips in (5, 10, 20):
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
        reported, and its PSNR reads low."""
        out = {}
        for split, cams in (("test", self.scene.test_cameras),
                            ("train", self.scene.train_cameras[:5])):
            if not cams:
                continue
            psnrs, l1s = [], []
            for vi, cam in enumerate(cams):
                r = step_lib.eval_image(
                    cam, self.state, self.bg,
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
        active = self.state.active
        self.logger.histogram("scene/opacity_histogram",
                              self.state.get_opacity()[active], it)
        self.logger.scalar("total_points", float(active.sum()), it)
        self.history.append({"iteration": it, **out})
        return out

    def save_snapshot(self, it: int) -> None:
        print(f"[it {it}] saving snapshot", flush=True)
        ckpt.save_model_snapshot(self.model_cfg.model_path, it, self.state,
                                 image_names=self.scene.exposure_ids)
