"""Adam for the Gaussian parameters: per-group learning rates, eps 1e-15,
and a sparse (visible-rows-only) variant (counterpart of the JAX package's
``train/optim.py``).

Semantics:
  * dense mode is torch.optim.Adam's: bias-corrected, eps added to the
    square root (1e-15 for the Gaussian groups, 1e-8 for exposure);
  * sparse mode is the reference's SparseGaussianAdam: moments and
    parameters advance only for rows visible this step (radii > 0), with no
    bias correction.
The functions work on plain tensors and return new ones: the step count is
a 0-dim int32 tensor on the card, so no step reads a value back to the
host. Because the store has a fixed capacity, the reference's optimizer
surgery on densify is :func:`zero_moments_rows` on masked rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.gaussians import PARAM_NAMES, GaussianParams

B1, B2 = 0.9, 0.999
EPS_GAUSS = 1e-15
EPS_EXPOSURE = 1e-8

# Per-Gaussian groups (first axis = capacity); exposure is per image.
PER_GAUSSIAN = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity")


@dataclasses.dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    count: torch.Tensor  # () int32, the shared step count

    def replace(self, **kw) -> "AdamState":
        return dataclasses.replace(self, **kw)


def init_adam(params: GaussianParams) -> AdamState:
    def zeros():
        return GaussianParams(**{k: torch.zeros_like(getattr(params, k))
                                 for k in PARAM_NAMES})
    return AdamState(mu=zeros(), nu=zeros(),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=params.xyz.device))


@dataclasses.dataclass(frozen=True)
class LearningRates:
    """Per-group learning rates for one step."""

    xyz: float
    features_dc: float
    features_rest: float
    scaling: float
    rotation: float
    opacity: float
    exposure: float


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def adam_update(params: GaussianParams, grads: GaussianParams,
                state: AdamState, lrs: LearningRates,
                visibility: Optional[torch.Tensor] = None,
                sparse: bool = False):
    """One Adam step. Returns (new_params, new_state)."""
    count = state.count + 1
    t = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(B1, t)
    bc2 = 1.0 - torch.pow(B2, t)
    new_p, new_mu, new_nu = {}, {}, {}
    for name in PARAM_NAMES:
        p = getattr(params, name)
        g = getattr(grads, name)
        mu = getattr(state.mu, name)
        nu = getattr(state.nu, name)
        lr = getattr(lrs, name)
        eps = EPS_EXPOSURE if name == "exposure" else EPS_GAUSS
        mu_n = B1 * mu + (1.0 - B1) * g
        nu_n = B2 * nu + (1.0 - B2) * g * g
        if sparse and name in PER_GAUSSIAN:
            vis = _rows(visibility, p)
            mu_n = torch.where(vis, mu_n, mu)
            nu_n = torch.where(vis, nu_n, nu)
            step = lr * mu_n / (torch.sqrt(nu_n) + eps)
            p_n = torch.where(vis, p - step, p)
        else:
            p_n = p - lr * (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + eps)
        new_p[name], new_mu[name], new_nu[name] = p_n, mu_n, nu_n
    return (GaussianParams(**new_p),
            AdamState(mu=GaussianParams(**new_mu),
                      nu=GaussianParams(**new_nu), count=count))


def zero_moments_rows(state: AdamState, row_mask: torch.Tensor,
                      only: Optional[tuple] = None) -> AdamState:
    """Zero the Adam moments of the masked rows (the fixed-capacity form of
    the reference's optimizer surgery on densify, prune and opacity
    reset)."""
    names = PER_GAUSSIAN if only is None else only

    def zero(tree):
        out = {}
        for name in PARAM_NAMES:
            leaf = getattr(tree, name)
            if name in names:
                leaf = torch.where(_rows(row_mask, leaf),
                                   torch.zeros_like(leaf), leaf)
            out[name] = leaf
        return GaussianParams(**out)

    return AdamState(mu=zero(state.mu), nu=zero(state.nu), count=state.count)
