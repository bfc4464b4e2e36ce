"""Depth-training losses (counterpart of the JAX package's
``depth/losses.py``; reference ``zoedepth/trainers/loss.py``).

Functions on tensors: (pred, target, mask) with shapes (..., H, W) ->
a 0-dim tensor. ``compute_scale_and_shift`` is the closed-form least
squares that the scale-invariant loss uses.

Gradients follow ``jax.grad`` of the JAX functions where torch's own
differ: :func:`maximum` and :func:`clip` split the gradient half and half
at an exact tie, as ``jnp.maximum`` and ``jnp.clip`` do (``torch.clamp``
passes all of it), and :func:`jax_abs` passes +1 at 0 (``torch.abs`` 0).

SILog and GradL1 are means over every masked pixel of the batch, not over
samples. With `group` (a process group) the batch is the union of the
ranks' shares: the sums are all-reduced inside autograd, so each rank's
backward of the global loss yields its share of the global gradient times
the world size, and averaging the parameter gradients over the ranks gives
the gradient of the global loss.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: half the gradient to `x` at a tie. (The
    bound is filled on the device: a tensor copied from a Python number
    waits for the card.)"""
    return torch.maximum(x, x.new_full((), lo))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` (a maximum, then a minimum): half the
    gradient to `x` at either bound."""
    return torch.minimum(maximum(x, lo), x.new_full((), hi))


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``, whose gradient at 0 is +1."""
    return torch.where(x >= 0, x, -x)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over `group` whose backward all-reduces the
    cotangents: each rank's backward of the same global loss gets the
    world size times its share of the gradient (what the deprecated
    ``torch.distributed.nn.functional.all_reduce`` computes)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def total(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of `x` (over the ranks of `group` when one is given,
    differentiably)."""
    s = torch.sum(x)
    return s if group is None else _SumOverRanks.apply(s, group)


def _mask_like(pred, mask):
    return torch.ones_like(pred, dtype=torch.bool) if mask is None else mask


def silog_loss(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor | None = None, beta: float = 0.15,
               eps: float = 1e-6, group=None) -> torch.Tensor:
    """Scale-invariant log loss: 10·sqrt(var(g) + β·mean(g)²), g the log
    ratio over the masked pixels (``loss.py:42-93``). The variance is the
    mean squared deviation from the mean, as the JAX function computes
    it."""
    mask = _mask_like(pred, mask)
    g = torch.log(maximum(pred, eps)) - torch.log(maximum(target, eps))
    zero = g.new_zeros(())
    n = torch.clamp_min(total(mask.to(g.dtype), group), 1.0)
    mean = total(torch.where(mask, g, zero), group) / n
    var = total(torch.where(mask, (g - mean) ** 2, zero), group) / n
    return 10.0 * torch.sqrt(var + beta * mean * mean)


def grad_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                 mask: torch.Tensor | None = None,
                 group=None) -> torch.Tensor:
    """L1 on the x and y image gradients of the depth map
    (``loss.py:110-134``), each a mean over the pixel pairs that both lie
    in the mask."""
    mask = _mask_like(pred, mask)

    def grads(x):
        return x[..., :, 1:] - x[..., :, :-1], x[..., 1:, :] - x[..., :-1, :]

    px, py = grads(pred)
    tx, ty = grads(target)
    mx = mask[..., :, 1:] & mask[..., :, :-1]
    my = mask[..., 1:, :] & mask[..., :-1, :]
    zero = pred.new_zeros(())
    nx = torch.clamp_min(total(mx.to(pred.dtype), group), 1.0)
    ny = torch.clamp_min(total(my.to(pred.dtype), group), 1.0)
    return (total(torch.where(mx, jax_abs(px - tx), zero), group) / nx
            + total(torch.where(my, jax_abs(py - ty), zero), group) / ny)


def compute_scale_and_shift(prediction: torch.Tensor, target: torch.Tensor,
                            mask: torch.Tensor):
    """Closed-form (s, t) minimising ‖s·pred + t − target‖² over the mask,
    batched over the leading dims (``loss.py:259-283``). A system whose
    determinant is not positive gives (0, 0); the inner ``where`` keeps
    its division from putting NaN into the gradient."""
    m = mask.to(prediction.dtype)
    dims = (-2, -1)
    a00 = torch.sum(m * prediction * prediction, dim=dims)
    a01 = torch.sum(m * prediction, dim=dims)
    a11 = torch.sum(m, dim=dims)
    b0 = torch.sum(m * prediction * target, dim=dims)
    b1 = torch.sum(m * target, dim=dims)
    det = a00 * a11 - a01 * a01
    ok = det > 0
    safe = torch.where(ok, det, torch.ones_like(det))
    zero = det.new_zeros(())
    scale = torch.where(ok, (a11 * b0 - a01 * b1) / safe, zero)
    shift = torch.where(ok, (-a01 * b0 + a00 * b1) / safe, zero)
    return scale, shift


def scale_and_shift_invariant_loss(pred: torch.Tensor, target: torch.Tensor,
                                   mask: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """MiDaS-style SSI loss (``loss.py:286-305``)."""
    mask = _mask_like(pred, mask)
    s, t = compute_scale_and_shift(pred, target, mask)
    res = (s[..., None, None] * pred + t[..., None, None] - target) ** 2
    n = torch.clamp_min(torch.sum(mask.to(pred.dtype)), 1.0)
    return torch.sum(torch.where(mask, res, res.new_zeros(()))) / n


def sid_label(target: torch.Tensor, k: int, top: int, t_min: float,
              t_max: float, eps: float) -> torch.Tensor:
    """The SID bin of each target depth: ``clip(int32(ratio·k), 0, top)``
    with ratio = log(max(target, eps)/t_min)/log(t_max/t_min). XLA's cast
    saturates ±inf and maps NaN to 0, and truncates toward zero; a torch
    cast of inf is undefined, so the value is clamped in float first
    (which keeps the truncation: a value in (-1, 0) still becomes 0)."""
    ratio = (torch.log(maximum(target, eps) / t_min)
             / torch.log(target.new_full((), t_max / t_min)))
    x = torch.nan_to_num(ratio * k, nan=0.0)
    return torch.clamp(x, 0.0, float(top)).to(torch.int64)


def ordinal_regression_loss(probs: torch.Tensor, target: torch.Tensor,
                            t_min: float, t_max: float,
                            eps: float = 1e-6) -> torch.Tensor:
    """SID ordinal regression over (B, K, H, W) per-bin probabilities
    (``loss.py:137-180`` semantics)."""
    k = probs.shape[1]
    label = sid_label(target, k, k, t_min, t_max, eps)
    ks = torch.arange(k, device=probs.device).view(1, k, 1, 1)
    below = ks < label[:, None]
    p = clip(probs, eps, 1.0 - eps)
    ll = torch.where(below, torch.log(p), torch.log(1.0 - p))
    return -torch.mean(torch.sum(ll, dim=1))


def discrete_nll_loss(log_probs: torch.Tensor, target: torch.Tensor,
                      t_min: float, t_max: float,
                      eps: float = 1e-6) -> torch.Tensor:
    """Cross-entropy against the SID-discretised depth
    (``loss.py:183-254``)."""
    k = log_probs.shape[1]
    label = sid_label(target, k, k - 1, t_min, t_max, eps)
    return -torch.mean(torch.gather(log_probs, 1, label[:, None]))
