"""Data-parallel depth trainer (counterpart of the JAX package's
``depth/trainer.py``; reference ``zoedepth/trainers/base_trainer.py`` +
``zoedepth_trainer.py``, the reference's only distributed training
outside the splatting trainer).

The JAX trainer shards the batch over a ``data`` mesh and lets XLA insert
the gradient all-reduce; here each rank of the default process group (one
rank when none is initialised) holds a replica of the module and its share
of the global batch. The loss is the JAX trainer's one number over the
global batch: SILog + ``w_grad``·GradL1 over every masked pixel of all the
ranks' shares, their sums all-reduced inside autograd (``losses``); the
parameter gradients are then averaged over the ranks, so every rank holds
the gradient of the global loss and takes the same update.

The optimizer is optax's ``chain(clip_by_global_norm(0.1), adamw(
onecycle_lr, weight_decay))`` written out: the clip over all parameters
as ``(g / ‖g‖)·0.1`` when ‖g‖ ≥ 0.1; Adam with b1 0.9, b2 0.999, eps 1e-8
and bias correction; weight decay on every parameter; the learning rate of
the update count before it (0 on the first). Rank 0 logs and writes the
checkpoints, in the JAX pickle layout.

As in the JAX trainer, the NK router's domain cross-entropy is never part
of the loss (its ``train_step`` passes no domain label), so ``w_domain``
is unused and ``DepthModelNK`` trains through its soft route.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from .. import interop
from ..device import resolve_device
from . import losses

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
CLIP_NORM = 0.1


def onecycle_lr(step, total_steps: int, max_lr: float,
                pct_start: float = 0.3, div_factor: float = 25.0,
                final_div_factor: float = 100.0) -> float:
    """OneCycle (cosine) learning rate as a pure function of the step, the
    JAX package's formula in float32: a cosine rise from max_lr/div_factor
    to max_lr over max(pct_start·total, 1) steps, then a cosine fall to
    max_lr/div_factor/final_div_factor at `total_steps`. (Not
    ``torch.optim.lr_scheduler.OneCycleLR``, whose phases end at
    pct·total − 1 and total − 1.)"""
    f32 = np.float32
    warm = f32(max(total_steps * pct_start, 1.0))
    init_lr = max_lr / div_factor
    final_lr = init_lr / final_div_factor
    step = f32(step)
    up = f32(init_lr) + f32((max_lr - init_lr) * 0.5) * (
        f32(1.0) - np.cos(f32(np.pi) * np.clip(step / warm, f32(0.0),
                                                f32(1.0))))
    t = np.clip((step - warm) / f32(max(total_steps - warm, 1.0)),
                f32(0.0), f32(1.0))
    down = f32(final_lr) + f32((max_lr - final_lr) * 0.5) * (
        f32(1.0) + np.cos(f32(np.pi) * t))
    return float(up if step < warm else down)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient becomes
    ``(g / ‖g‖)·max_norm`` unless the global norm ‖g‖ (over all of them)
    is below `max_norm`. Returns ‖g‖ (0-dim, on the device: no host
    read)."""
    g_norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads)))
    keep = g_norm < max_norm
    one = torch.ones_like(g_norm)
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return g_norm


def depth_loss(model: torch.nn.Module, cfg, image: torch.Tensor,
               depth_gt: torch.Tensor, mask: torch.Tensor,
               group=None) -> torch.Tensor:
    """The trainer's loss (JAX ``trainer.py:103-114``): SILog +
    ``cfg.w_grad``·GradL1 of the metric depth clipped to [min_depth,
    max_depth]; image (b, 3, H, W), depth_gt and mask (b, H, W). With
    `group`, over the union of its ranks' batches."""
    pred = losses.clip(model(image)["metric_depth"], cfg.min_depth,
                       cfg.max_depth)
    loss = losses.silog_loss(pred, depth_gt, mask, group=group)
    return loss + cfg.w_grad * losses.grad_l1_loss(pred, depth_gt, mask,
                                                   group=group)


@dataclasses.dataclass
class DepthTrainerConfig:
    lr: float = 1.61e-4
    weight_decay: float = 0.01
    epochs: int = 5
    steps_per_epoch: int = 1000
    w_grad: float = 0.5        # GradL1 weight (w_si = 1)
    w_domain: float = 0.1      # NK router CE weight
    min_depth: float = 1e-3
    max_depth: float = 10.0
    checkpoint_dir: str = ""
    # Experiment logging (reference base_trainer.py:151-156 wandb setup;
    # here the framework MetricsLogger: TB when available + JSONL).
    log_dir: str = ""
    log_every: int = 50


class DepthTrainer:
    """Data-parallel trainer of a port depth module (``depth/model.py``)
    on `device` (the card unless the caller names the CPU). The module
    brings its weights (``layers.build`` draws them from an explicit
    generator); with a process group, rank 0's are broadcast to the
    others."""

    def __init__(self, model: torch.nn.Module, cfg: DepthTrainerConfig,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.cfg = cfg
        self.total_steps = cfg.epochs * cfg.steps_per_epoch
        self.params = list(self.model.parameters())
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.group = dist.group.WORLD if self.world > 1 else None
        if self.group is not None:
            with torch.no_grad():
                for p in self.params:
                    dist.broadcast(p, 0)
        self.step_count = 0
        self.reset_optimizer()
        # Rank-0-only structured experiment logging (the reference's wandb
        # role, base_trainer.py:151-156/197-199): scalars per train step,
        # eval metric dicts, colorized depth images.
        self.logger = None
        if cfg.log_dir and self.is_rank_zero:
            from ..utils.logging import MetricsLogger  # noqa: PLC0415
            self.logger = MetricsLogger(cfg.log_dir)

    @property
    def is_rank_zero(self) -> bool:
        return not dist.is_initialized() or dist.get_rank() == 0

    def reset_optimizer(self) -> None:
        """Fresh optimizer state: zero moments, update count 0 (optax's
        ``init``)."""
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.opt_count = 0

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype)

    def loss(self, image, depth_gt, mask) -> torch.Tensor:
        """The global loss of this rank's share: image (b, H, W, 3) NHWC,
        depth_gt and mask (b, H, W)."""
        return depth_loss(self.model, self.cfg,
                          self._tensor(image).permute(0, 3, 1, 2),
                          self._tensor(depth_gt),
                          self._tensor(mask, torch.bool), group=self.group)

    def gradients(self, image, depth_gt, mask):
        """(global loss, [gradient of it per parameter]), the gradients
        averaged over the ranks."""
        loss = self.loss(image, depth_gt, mask)
        grads = torch.autograd.grad(loss, self.params)
        if self.group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            flat /= self.world
            grads = [f.view_as(g) for f, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
        return loss.detach(), list(grads)

    @torch.no_grad()
    def apply_gradients(self, grads) -> None:
        """One optimizer update from `grads` (consumed): the clip, then
        AdamW at the learning rate of the update count."""
        clip_by_global_norm_(grads, CLIP_NORM)
        torch._foreach_mul_(self.mu, ADAM_B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - ADAM_B1))
        torch._foreach_mul_(self.nu, ADAM_B2)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - ADAM_B2)
        torch._foreach_add_(self.nu, sq)
        count = np.float32(self.opt_count + 1)
        bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** count)
        bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** count)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                    self.cfg.weight_decay))
        lr = onecycle_lr(self.opt_count, self.total_steps, self.cfg.lr)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)
        self.opt_count += 1

    def train_step(self, image, depth_gt, mask) -> float:
        """One update on this rank's share of the global batch: image
        (b, H, W, 3) NHWC in [0, 1], depth_gt and mask (b, H, W), numpy
        or tensors. Returns the global loss."""
        loss, grads = self.gradients(image, depth_gt, mask)
        self.apply_gradients(grads)
        self.step_count += 1
        loss = float(loss)
        if self.logger and self.step_count % self.cfg.log_every == 0:
            self.logger.scalar("Train/loss", loss, self.step_count)
        return loss

    def log_eval(self, metrics: dict, prefix: str = "Metrics") -> None:
        """Log an eval-metric dict (reference base_trainer.py:197-199)."""
        if self.logger:
            self.logger.scalars({f"{prefix}/{k}": float(v)
                                 for k, v in metrics.items()},
                                self.step_count)

    def log_depth_images(self, image, depth_gt, pred,
                         tag: str = "Eval") -> None:
        """Colorized input/GT/prediction triplet
        (reference base_trainer.py:289-308 log_images)."""
        if not self.logger:
            return
        from .metrics import colorize  # noqa: PLC0415

        def host(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            return np.asarray(x).squeeze()
        img, gt, pr = host(image), host(depth_gt), host(pred)
        self.logger.image(f"{tag}/input",
                          np.transpose(np.clip(img, 0, 1), (2, 0, 1)),
                          self.step_count)
        for name, d in (("gt", gt), ("pred", pr)):
            rgba = colorize(d, invalid_mask=~np.isfinite(d) | (d <= 0))
            self.logger.image(
                f"{tag}/{name}",
                np.transpose(rgba[..., :3] / 255.0, (2, 0, 1)),
                self.step_count)

    def save_checkpoint(self, name: str = "latest.pkl") -> None:
        """Rank-0-only model checkpoint in the JAX package's layout,
        ``{"params": <flax variables of numpy arrays>, "step": n}``;
        optimizer state deliberately dropped (``base_trainer.py:273-287``).
        """
        if not self.is_rank_zero or not self.cfg.checkpoint_dir:
            return
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.cfg.checkpoint_dir, name)
        with open(path, "wb") as f:
            pickle.dump({"params": interop.depth_params_to_numpy(self.model),
                         "step": self.step_count}, f)

    def load_checkpoint(self, path: str) -> None:
        """Weights and step of a checkpoint of either package's depth
        trainer; the optimizer starts afresh, its update count at 0, as
        the JAX trainer's does."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        interop.depth_module_from_numpy(payload["params"], self.model)
        self.step_count = payload["step"]
        self.reset_optimizer()
