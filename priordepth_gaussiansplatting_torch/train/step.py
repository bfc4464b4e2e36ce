"""One training iteration and the evaluation render (counterpart of the
JAX package's ``train/step.py``).

The step renders one view, takes L1 + D-SSIM (+ depth-L1 against the
camera's inverse-depth prior), differentiates through the compositor's
backward (K3) and the binning's (K5b, K4) and the projection by autograd,
applies Adam, and accumulates the densification statistics. The screen-space
gradient that densification thresholds is the gradient of a zeros
``screen_offset`` added to the projected 2D means (``ops/render.py``).

It is a function of (state, opt_state, camera, step, generator, bg) that
returns new tensors: the parameters are fresh leaves that need a gradient,
and ``torch.autograd.grad`` hands back the gradients without touching
``.grad``. A step whose frame overflowed its pair capacity or whose loss is
not finite changes nothing but reports ``skipped``; that guard is a
``torch.where`` on the card, so the step never waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.cameras import Camera
from ..core.schedules import expon_lr
from ..models import densify as densify_ops
from ..models.gaussians import PARAM_NAMES, GaussianParams, GaussianState
from ..ops import losses
from ..ops.render import render
from ..utils.config import OptimizationConfig, PipelineConfig
from . import optim


def depth_l1_weight(step: int, cfg: OptimizationConfig) -> float:
    """1.0 -> 0.01 log-linear over the run."""
    return expon_lr(step, cfg.depth_l1_weight_init, cfg.depth_l1_weight_final,
                    max_steps=cfg.iterations)


def learning_rates(step: int, cfg: OptimizationConfig,
                   spatial_lr_scale: float) -> optim.LearningRates:
    """Per-group learning rates at `step`."""
    return optim.LearningRates(
        xyz=expon_lr(step, cfg.position_lr_init * spatial_lr_scale,
                     cfg.position_lr_final * spatial_lr_scale,
                     lr_delay_mult=cfg.position_lr_delay_mult,
                     max_steps=cfg.position_lr_max_steps),
        features_dc=cfg.feature_lr,
        features_rest=cfg.feature_lr / 20.0,
        scaling=cfg.scaling_lr,
        rotation=cfg.rotation_lr,
        opacity=cfg.opacity_lr,
        exposure=expon_lr(step, cfg.exposure_lr_init, cfg.exposure_lr_final,
                          lr_delay_steps=cfg.exposure_lr_delay_steps,
                          lr_delay_mult=cfg.exposure_lr_delay_mult,
                          max_steps=cfg.iterations),
    )


@dataclasses.dataclass(frozen=True)
class TrainStepFns:
    """The step, densify and opacity-reset functions for one setting."""

    step: Callable
    densify: Callable
    reset_opacity: Callable


def _where(ok: torch.Tensor, new, old):
    if isinstance(new, GaussianParams):
        return GaussianParams(**{k: torch.where(ok, getattr(new, k),
                                                getattr(old, k))
                                 for k in PARAM_NAMES})
    if isinstance(new, optim.AdamState):
        return optim.AdamState(mu=_where(ok, new.mu, old.mu),
                               nu=_where(ok, new.nu, old.nu),
                               count=torch.where(ok, new.count, old.count))
    return torch.where(ok, new, old)


def make_train_step(opt_cfg: OptimizationConfig, pipe_cfg: PipelineConfig,
                    use_trained_exp: bool = False,
                    pair_capacity: Optional[int] = None,
                    valid_capacity: Optional[int] = None) -> TrainStepFns:
    """The train step closed over its hyperparameters. `pair_capacity` and
    `valid_capacity` size the rasterizer's pair lists (the trainer adapts
    them from the ``num_pairs`` and ``overflow`` metrics)."""
    sparse = opt_cfg.optimizer_type == "sparse_adam"

    def train_step(state: GaussianState, opt_state: optim.AdamState,
                   camera: Camera, step: int,
                   generator: Optional[torch.Generator],
                   bg_color: torch.Tensor):
        dev = state.params.xyz.device
        if opt_cfg.random_background:
            bg = torch.rand(3, generator=generator, device=dev)
        else:
            bg = bg_color
        leaves = {k: getattr(state.params, k).detach().requires_grad_(True)
                  for k in PARAM_NAMES}
        screen_offset = torch.zeros(state.capacity, 2, device=dev,
                                    requires_grad=True)
        with torch.enable_grad():
            out = render(camera, state.replace(params=GaussianParams(**leaves)),
                         bg, antialiasing=pipe_cfg.antialiasing,
                         use_trained_exp=use_trained_exp,
                         screen_offset=screen_offset,
                         backend=pipe_cfg.backend,
                         pair_capacity=pair_capacity,
                         valid_capacity=valid_capacity)
            image = out["render"]
            if camera.alpha_mask is not None:
                image = image * camera.alpha_mask[None]
            ll1 = losses.l1_loss(image, camera.image)
            ssim_v = losses.ssim(image, camera.image)
            loss = ((1.0 - opt_cfg.lambda_dssim) * ll1
                    + opt_cfg.lambda_dssim * (1.0 - ssim_v))
            dloss = torch.zeros((), device=dev)
            if opt_cfg.depth_feedback and camera.invdepth is not None:
                mask = (camera.depth_mask if camera.depth_mask is not None
                        else torch.ones_like(camera.invdepth))
                dloss = depth_l1_weight(step, opt_cfg) * losses.depth_l1_loss(
                    out["invdepth"][0], camera.invdepth, mask)
                loss = loss + dloss
            inputs = list(leaves.values()) + [screen_offset]
            got = torch.autograd.grad(loss, inputs, allow_unused=True)
        got = [torch.zeros_like(x) if g is None else g
               for x, g in zip(inputs, got)]
        grads = GaussianParams(**dict(zip(PARAM_NAMES, got[:-1])))
        screen_grad = got[-1]
        loss, ll1, ssim_v, dloss = (x.detach()
                                    for x in (loss, ll1, ssim_v, dloss))

        radii = out["radii"]
        visibility = radii > 0
        lrs = learning_rates(step, opt_cfg, state.spatial_lr_scale)
        new_params, new_opt = optim.adam_update(
            state.params, grads, opt_state, lrs, visibility=visibility,
            sparse=sparse)
        # An overflowed frame was missing pairs and a non-finite loss is a
        # degenerate frame: either way the update is dropped (and counted).
        ok = torch.isfinite(loss)
        if out.get("overflow") is not None:
            ok = ok & (out["overflow"] == 0)
        state = state.replace(params=_where(ok, new_params, state.params))
        opt_state = _where(ok, new_opt, opt_state)
        stats = densify_ops.add_densification_stats(
            state, screen_grad, radii, camera.width, camera.height)
        state = state.replace(**{k: _where(ok, getattr(stats, k),
                                           getattr(state, k))
                                 for k in ("max_radii2d",
                                           "xyz_gradient_accum", "denom")})
        metrics = {
            "loss": loss, "l1": ll1, "ssim": ssim_v, "depth_loss": dloss,
            "n_visible": torch.sum(visibility.to(torch.int32)),
            "n_active": state.num_active,
            "skipped": (~ok).to(torch.int32),
        }
        if out.get("num_pairs") is not None:
            metrics["num_pairs"] = out["num_pairs"]
            metrics["overflow"] = out["overflow"]
        return state, opt_state, metrics

    def densify(state, opt_state, use_size_threshold: bool = False,
                noise=None, generator=None):
        # The 20 px size threshold applies only after the first opacity
        # reset, as in the reference.
        return densify_ops.densify_and_prune(
            state, opt_state, opt_cfg.densify_grad_threshold, 0.005,
            state.spatial_lr_scale, 20.0 if use_size_threshold else 0.0,
            percent_dense=opt_cfg.percent_dense, noise=noise,
            generator=generator)

    return TrainStepFns(step=train_step, densify=densify,
                        reset_opacity=densify_ops.reset_opacity)


@torch.no_grad()
def eval_image(camera: Camera, state: GaussianState, bg: torch.Tensor,
               antialiasing: bool = False, use_trained_exp: bool = False,
               backend: str = "auto", pair_capacity: Optional[int] = None):
    """No-grad render plus PSNR/L1 against the camera's image, if any.
    ``overflow`` is returned so callers can warn: an overflowed render is
    missing pairs."""
    out = render(camera, state, bg, antialiasing=antialiasing,
                 use_trained_exp=use_trained_exp, backend=backend,
                 pair_capacity=pair_capacity)
    img = out["render"]
    res = {"render": img}
    if out.get("overflow") is not None:
        res["overflow"] = out["overflow"]
    if camera.image is not None:
        res["psnr"] = losses.psnr(img, camera.image)
        res["l1"] = losses.l1_loss(img, camera.image)
    return res
