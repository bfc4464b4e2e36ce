"""Plain reference of a training step: render (``render.py``), the 3DGS
loss (0.8 L1 + 0.2 (1 - SSIM), plus the depth-L1 term against an
inverse-depth prior), the gradients, Adam with per-group learning rates,
and the densification statistics, in plain PyTorch.

Definitions follow the 3DGS reference's ``train.py``, ``utils/loss_utils``
(SSIM: 11x11 Gaussian window, sigma 1.5, zero-padded, C1 = 0.01^2,
C2 = 0.03^2), ``utils/general_utils.get_expon_lr_func`` and
``torch.optim.Adam`` (eps 1e-15 for the Gaussian groups). SSIM and every
product run in true float32: TF32 is switched off while a step runs.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import render as rr

GROUPS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
B1, B2, EPS = 0.9, 0.999, 1e-15


@contextlib.contextmanager
def true_f32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def expon_lr(step: int, lr_init: float, lr_final: float, delay_steps: int = 0,
             delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    """``get_expon_lr_func`` of the 3DGS reference."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if delay_steps > 0:
        delay = delay_mult + (1 - delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1 - t)
                            + math.log(lr_final) * t)


def learning_rates(step: int, opt: dict, extent: float) -> dict:
    """Per-group learning rates of the 3DGS reference at `step`."""
    return {
        "xyz": expon_lr(step, opt["position_lr_init"] * extent,
                        opt["position_lr_final"] * extent,
                        delay_mult=opt["position_lr_delay_mult"],
                        max_steps=opt["position_lr_max_steps"]),
        "features_dc": opt["feature_lr"],
        "features_rest": opt["feature_lr"] / 20.0,
        "scaling": opt["scaling_lr"],
        "rotation": opt["rotation_lr"],
        "opacity": opt["opacity_lr"],
    }


def _window(dtype, device) -> torch.Tensor:
    xs = np.arange(11) - 5
    g = np.exp(-(xs ** 2) / (2.0 * 1.5 ** 2))
    return torch.as_tensor(g / g.sum(), dtype=dtype, device=device)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images: the 11x11 window applied as two
    zero-padded 1-D passes."""
    w = _window(img1.dtype, img1.device)

    def blur(x):
        y = F.conv2d(x[:, None], w.view(1, 1, 1, 11), padding=(0, 5))
        return F.conv2d(y, w.view(1, 1, 11, 1), padding=(5, 0))[:, 0]

    mu1, mu2 = blur(img1), blur(img2)
    s11 = blur(img1 * img1) - mu1 * mu1
    s22 = blur(img2 * img2) - mu2 * mu2
    s12 = blur(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
         / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)))
    return m.mean()


def loss_fn(image, invdepth, target, prior, depth_weight: float,
            lambda_dssim: float = 0.2, half: bool = False):
    """The step's loss. `half` keeps only the top half of the image's rows
    (the mean taken over the rest): a planted fault, for the check's own
    calibration."""
    if half:
        rows = image.shape[1] // 2
        image, target = image[:, :rows], target[:, :rows]
        if prior is not None:
            invdepth, prior = invdepth[:rows], prior[:rows]
    loss = ((1.0 - lambda_dssim) * (image - target).abs().mean()
            + lambda_dssim * (1.0 - ssim(image, target)))
    if prior is not None:
        loss = loss + depth_weight * (invdepth - prior).abs().mean()
    return loss


def step(params: dict, mu: dict, nu: dict, count: int, view: dict,
         target: torch.Tensor, prior, bg: torch.Tensor, it: int, opt: dict,
         extent: float, sh_degree: int = 3, half: bool = False):
    """One training step at iteration `it`. Returns (loss, grads, new params,
    new mu, new nu, screen-space gradient norm scaled as the densification
    statistic, visibility)."""
    width, height = view["width"], view["height"]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    offset = torch.zeros(params["xyz"].shape[0], 2, dtype=params["xyz"].dtype,
                         device=params["xyz"].device, requires_grad=True)
    with torch.enable_grad():
        proj = rr.project(leaves, view, sh_degree, screen_offset=offset)
    attrs = proj["attrs"]
    pairs = rr.tile_pairs(attrs, proj["depth"], proj["radius"], width, height)
    fwd = rr.render(attrs.detach(), pairs, width, height, bg)
    colour = fwd["colour"].requires_grad_(True)
    final_t = fwd["final_t"].requires_grad_(True)
    invd = fwd["invdepth"].requires_grad_(True)
    depth_weight = expon_lr(it, opt["depth_l1_weight_init"],
                            opt["depth_l1_weight_final"],
                            max_steps=opt["iterations"])
    with torch.enable_grad():
        image = torch.clamp(colour + final_t[None] * bg.to(colour.dtype)[:, None,
                                                                       None],
                            0.0, 1.0)
        loss = loss_fn(image, invd, target, prior, depth_weight,
                       opt["lambda_dssim"], half)
        d_colour, d_final_t, d_invd = torch.autograd.grad(
            loss, [colour, final_t, invd], allow_unused=True)
    if d_invd is None:
        d_invd = torch.zeros_like(invd)
    d_attrs = rr.composite_backward(attrs, pairs, width, height, d_colour,
                                    d_invd, d_final_t)
    with torch.enable_grad():
        torch.autograd.backward(attrs, d_attrs)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    screen = offset.grad
    lrs = learning_rates(it, opt, extent)
    t = count + 1
    bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
    new_p, new_mu, new_nu = {}, {}, {}
    for k in GROUPS:
        g = grads[k]
        new_mu[k] = B1 * mu[k] + (1.0 - B1) * g
        new_nu[k] = B2 * nu[k] + (1.0 - B2) * g * g
        new_p[k] = params[k] - lrs[k] * (new_mu[k] / bc1) / (
            torch.sqrt(new_nu[k] / bc2) + EPS)
    visible = proj["visible"]
    stat = torch.linalg.vector_norm(
        torch.stack([screen[:, 0] * (0.5 * width),
                     screen[:, 1] * (0.5 * height)], -1), dim=-1)
    stat = torch.where(visible, stat, torch.zeros_like(stat))
    return (loss.detach(), grads, new_p, new_mu, new_nu, stat.detach(),
            visible)
