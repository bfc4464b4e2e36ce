"""Metric-bins building blocks (counterpart of the JAX package's
``depth/layers.py``; reference ``zoedepth/models/layers/``): seed bin
regressors, projectors, attractor refinement, the conditional log-binomial
head and the patch-transformer domain router, as ``nn.Module``s.

Layout: feature maps are NCHW, (B, C, H, W); token sequences (B, N, E).
Submodules carry the names that flax gives the JAX modules' parameters
(``Conv_0``, ``Dense_3``, ``LayerNorm_2``, ``SelfAttention_1`` with
``query``/``key``/``value``/``out``), so ``interop.depth_module_from_numpy``
maps a flax tree onto them leaf by leaf. A module is made with
:func:`build`, which draws every weight from an explicit
``torch.Generator`` as flax initialises it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

# flax's LayerNorm epsilon (torch's is 1e-5).
FLAX_LN_EPS = 1e-6


def build(cls, *args, generator: torch.Generator | None = None,
          device=None, **kwargs) -> nn.Module:
    """``cls(*args, **kwargs)`` with its weights drawn from `generator` (a
    CPU generator; seed 0 when None) by :func:`init_weights`, on `device`
    (the card unless the caller names the CPU). The module is made on the
    meta device first, so the global RNG is left alone."""
    device = resolve_device(device)
    with torch.device("meta"):
        module = cls(*args, **kwargs)
    module = module.to_empty(device="cpu")
    init_weights(module, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return module.to(device)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers: convolution and dense kernels lecun-normal
    (truncated at two standard deviations), biases 0, LayerNorm scales 1,
    LayerScale multipliers 1, ``cls_pos_embed`` 0, and the other tables
    (positional rows, class and register tokens) N(0, 0.02)."""
    for mod in module.modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.Conv2d, nn.Linear)) and leaf == "weight":
                fan_in = p[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            elif leaf == "bias" or leaf == "cls_pos_embed":
                p.zero_()
            elif isinstance(mod, nn.LayerNorm) or leaf.startswith("ls"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)


def conv(cin: int, cout: int, k: int = 1, stride: int = 1) -> nn.Conv2d:
    """flax ``nn.Conv`` with "SAME" padding for stride 1 (odd `k`); strided
    convolutions pad in :func:`same_pad` first."""
    return nn.Conv2d(cin, cout, k, stride=stride,
                     padding=k // 2 if stride == 1 else 0)


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """The padding flax's "SAME" gives a (k, stride) convolution: the output
    is ceil(size / stride), the total padding is split with its smaller
    half on the low side, which ``nn.Conv2d`` cannot express."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def resize_align_corners(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) with ``align_corners=True`` (the
    ZoeDepth head's ``F.interpolate`` calls); a target of one pixel takes
    pixel 0, as the JAX version does."""
    th, tw = int(hw[0]), int(hw[1])
    if tuple(x.shape[-2:]) == (th, tw):
        return x
    return F.interpolate(x, size=(th, tw), mode="bilinear",
                         align_corners=True)


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of (B, C, H, W): half-pixel
    centres, weights renormalised at the borders, antialiased when it
    shrinks an axis."""
    th, tw = int(hw[0]), int(hw[1])
    h, w = x.shape[-2:]
    if (h, w) == (th, tw):
        return x
    return F.interpolate(x, size=(th, tw), mode="bilinear",
                         align_corners=False, antialias=th < h or tw < w)


def gelu(x: torch.Tensor, exact: bool) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh form unless `exact` (erf)."""
    return F.gelu(x, approximate="none" if exact else "tanh")


class SelfAttention(nn.Module):
    """flax ``nn.SelfAttention``: query, key, value and output projections
    with biases over `num_heads` heads, softmax(q k^T / sqrt(d)) v.

    On the card ``F.scaled_dot_product_attention`` computes it while
    ``fused`` is set; otherwise, and on the CPU, the plain einsum and
    softmax form (:meth:`plain`)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"{dim} features do not split into "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.fused = True
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    @staticmethod
    def plain(q, k, v):
        """(B, heads, N, d) -> (B, heads, N, d)."""
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q, k), dim=-1)
        return torch.einsum("bhnm,bhmd->bhnd", w, v)

    def forward(self, x):
        b, n, e = x.shape
        h = self.num_heads

        def heads(lin):
            return lin(x).view(b, n, h, e // h).transpose(1, 2)
        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        if self.fused and x.is_cuda:
            y = F.scaled_dot_product_attention(q, k, v)
        else:
            y = self.plain(q, k, v)
        return self.out(y.transpose(1, 2).reshape(b, n, e))


def use_fused_attention(module: nn.Module, fused: bool) -> None:
    """Set every attention layer of `module` to the fused route on the
    card (True) or to the plain form (False)."""
    for m in module.modules():
        if isinstance(m, SelfAttention):
            m.fused = fused


class _TwoConv(nn.Module):
    """Conv_0 (1x1) -> ReLU -> Conv_1 (1x1), the shape of the head's
    small networks."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.Conv_0 = conv(cin, mid)
        self.Conv_1 = conv(mid, cout)

    def hidden(self, x):
        return F.relu(self.Conv_0(x))


class SeedBinRegressor(_TwoConv):
    """Initial bin widths over [min_depth, max_depth]
    (``localbins_layers.py:29-69``: ReLU widths + 1e-3, range-normalised,
    cumsum edges). (B, C, H, W) -> (normalised widths, centres), each
    (B, n_bins, H, W)."""

    def __init__(self, in_features: int, n_bins: int = 16,
                 mlp_dim: int = 256, min_depth: float = 1e-3,
                 max_depth: float = 10.0):
        super().__init__(in_features, mlp_dim, n_bins)
        self.min_depth, self.max_depth = min_depth, max_depth

    def forward(self, x):
        w = F.relu(self.Conv_1(self.hidden(x))) + 1e-3
        widths_norm = w / torch.sum(w, dim=1, keepdim=True)
        widths = (self.max_depth - self.min_depth) * widths_norm
        widths = torch.cat([torch.full_like(widths[:, :1], self.min_depth),
                            widths], dim=1)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return widths_norm, centers


class SeedBinRegressorUnnormed(_TwoConv):
    """Softplus bin centres without range normalisation
    (``localbins_layers.py:72-96``); min/max_depth are accepted and unused,
    as in the torch API."""

    def __init__(self, in_features: int, n_bins: int = 16,
                 mlp_dim: int = 256, min_depth: float = 1e-3,
                 max_depth: float = 10.0):
        super().__init__(in_features, mlp_dim, n_bins)

    def forward(self, x):
        centers = F.softplus(self.Conv_1(self.hidden(x)))
        return centers, centers


class Projector(_TwoConv):
    """1x1 conv feature projector (``localbins_layers.py`` Projector)."""

    def __init__(self, in_features: int, out_features: int = 128,
                 mlp_dim: int = 128):
        super().__init__(in_features, mlp_dim, out_features)

    def forward(self, x):
        return self.Conv_1(self.hidden(x))


def _attract(dx, alpha, gamma, attractor_type):
    """exp/inv attractor delta (``attractor.py:30-58``)."""
    if attractor_type == "exp":
        return torch.exp(-alpha * torch.abs(dx) ** gamma) * dx
    return dx / (1.0 + alpha * dx ** gamma)


def _attractor_delta(a, b_centers, alpha, gamma, kind, attractor_type):
    """a: (B, A, H, W); b_centers: (B, n_bins, H, W) -> (B, n_bins, H, W)."""
    dist = _attract(a[:, :, None] - b_centers[:, None], alpha, gamma,
                    attractor_type)
    return dist.mean(dim=1) if kind == "mean" else dist.sum(dim=1)


class AttractorLayer(_TwoConv):
    """Bin-centre refinement in normalised bin space
    (``attractor.py:61-137``): 2·A channels, of which the first of each
    pair plus 1e-3 are the attractor points (the reference's pairwise
    normalisation is overwritten, as there); deltas move the normalised
    centres, and the scaled output is sorted and clipped."""

    def __init__(self, in_features: int, n_bins: int = 16,
                 n_attractors: int = 16, mlp_dim: int = 128,
                 alpha: float = 300.0, gamma: int = 2, kind: str = "sum",
                 attractor_type: str = "exp", min_depth: float = 1e-3,
                 max_depth: float = 10.0):
        super().__init__(in_features, mlp_dim, n_attractors * 2)
        self.n_attractors = n_attractors
        self.alpha, self.gamma, self.kind = alpha, gamma, kind
        self.attractor_type = attractor_type
        self.min_depth, self.max_depth = min_depth, max_depth

    def forward(self, x, b_prev, prev_b_embedding=None):
        # x: (B, C, H, W) embedding; b_prev: (B, n_bins, h, w) normalised.
        if prev_b_embedding is not None:
            x = x + resize_align_corners(prev_b_embedding, x.shape[-2:])
        a = F.relu(self.Conv_1(self.hidden(x))) + 1e-3
        b, _, h, w = a.shape
        a = a.view(b, self.n_attractors, 2, h, w)[:, :, 0]
        b_centers = resize_align_corners(b_prev, x.shape[-2:])
        b_new = b_centers + _attractor_delta(
            a, b_centers, self.alpha, self.gamma, self.kind,
            self.attractor_type)
        scaled = (self.max_depth - self.min_depth) * b_new + self.min_depth
        scaled = torch.clamp(torch.sort(scaled, dim=1).values,
                             self.min_depth, self.max_depth)
        return b_new, scaled


class AttractorLayerUnnormed(_TwoConv):
    """Unbounded bin-centre refinement (``attractor.py:139-214``, the
    ``softplus`` bin_centers_type): softplus attractor points, deltas in
    metric space, no clipping."""

    def __init__(self, in_features: int, n_bins: int = 16,
                 n_attractors: int = 16, mlp_dim: int = 128,
                 alpha: float = 300.0, gamma: int = 2, kind: str = "sum",
                 attractor_type: str = "exp", min_depth: float = 1e-3,
                 max_depth: float = 10.0):
        super().__init__(in_features, mlp_dim, n_attractors)
        self.alpha, self.gamma, self.kind = alpha, gamma, kind
        self.attractor_type = attractor_type

    def forward(self, x, b_prev, prev_b_embedding=None):
        if prev_b_embedding is not None:
            x = x + resize_align_corners(prev_b_embedding, x.shape[-2:])
        a = F.softplus(self.Conv_1(self.hidden(x)))
        b_centers = resize_align_corners(b_prev, x.shape[-2:])
        b_new = b_centers + _attractor_delta(
            a, b_centers, self.alpha, self.gamma, self.kind,
            self.attractor_type)
        return b_new, b_new


class ConditionalLogBinomial(nn.Module):
    """Per-pixel log-binomial mixture over bins conditioned on features
    (``dist_layers.py:73-120`` with the Stirling ``log_binom`` of
    ``:29-33``). (feat, cond) -> (B, n_bins, H, W) probabilities."""

    def __init__(self, in_features: int, n_bins: int = 16,
                 bottleneck_factor: int = 2, p_eps: float = 1e-4,
                 min_temp: float = 1e-7, max_temp: float = 50.0):
        super().__init__()
        bottleneck = in_features // bottleneck_factor
        self.Conv_0 = conv(in_features, bottleneck)
        self.Conv_1 = conv(bottleneck, 4)
        self.n_bins, self.p_eps = n_bins, p_eps
        self.min_temp, self.max_temp = min_temp, max_temp

    def forward(self, feat, cond):
        x = torch.cat([feat, cond], dim=1)
        h = F.gelu(self.Conv_0(x))  # the exact (erf) GELU
        pt = F.softplus(self.Conv_1(h))
        p = pt[:, 0:2] + self.p_eps
        p = p[:, 0:1] / (p[:, 0:1] + p[:, 1:2])  # binomial p
        t = pt[:, 2:4] + self.p_eps
        t = t[:, 0:1] / (t[:, 0:1] + t[:, 1:2])
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        eps = 1e-7
        ki = torch.arange(self.n_bins, dtype=x.dtype,
                          device=x.device).view(1, -1, 1, 1)
        k = ki + eps
        n = torch.tensor(self.n_bins - 1, dtype=x.dtype,
                         device=x.device) + eps
        # The maximum guards the n == k endpoint, as in the JAX module:
        # n - k is 0 there and the term is exactly 0 either way.
        log_binom = (n * torch.log(n) - k * torch.log(k)
                     - (n - k) * torch.log(torch.clamp_min(n - k + eps,
                                                           eps)))
        pc = torch.clamp(p, 1e-4, 1.0)
        one_minus = torch.clamp(1 - p, 1e-4, 1.0)
        logits = (log_binom + ki * torch.log(pc)
                  + (self.n_bins - 1 - ki) * torch.log(one_minus))
        return torch.softmax(logits / t, dim=1)


class PatchTransformerEncoder(nn.Module):
    """Patch transformer with a learnable class token, the ZoeDepth-NK
    domain router (``patch_transformer.py:30-91``): (B, C, H, W) ->
    (B, 1 + patches, E) tokens, [:, 0] the router token. The
    ``patch_size`` convolution pads as flax's "SAME" does."""

    def __init__(self, in_channels: int, embed_dim: int = 128,
                 num_heads: int = 4, num_layers: int = 4,
                 patch_size: int = 10):
        super().__init__()
        e = self.embed_dim = embed_dim
        self.patch_size, self.num_layers = patch_size, num_layers
        self.Conv_0 = nn.Conv2d(in_channels, e, patch_size,
                                stride=patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, e))
        self.pos_embed = nn.Parameter(torch.empty(1, 512, e))
        for i in range(num_layers):
            self.add_module(f"LayerNorm_{2 * i}",
                            nn.LayerNorm(e, eps=FLAX_LN_EPS))
            self.add_module(f"SelfAttention_{i}", SelfAttention(e, num_heads))
            self.add_module(f"LayerNorm_{2 * i + 1}",
                            nn.LayerNorm(e, eps=FLAX_LN_EPS))
            self.add_module(f"Dense_{2 * i}", nn.Linear(e, 4 * e))
            self.add_module(f"Dense_{2 * i + 1}", nn.Linear(4 * e, e))

    def forward(self, x):
        p = self.patch_size
        tokens = self.Conv_0(same_pad(x, p, p))
        b, e = tokens.shape[:2]
        tokens = tokens.flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        n = tokens.shape[1]
        if n > self.pos_embed.shape[1]:
            raise ValueError(f"{n} tokens exceed the router's "
                             f"{self.pos_embed.shape[1]} positional rows")
        tokens = tokens + self.pos_embed[:, :n]
        for i in range(self.num_layers):
            sub = self.get_submodule
            y = sub(f"SelfAttention_{i}")(sub(f"LayerNorm_{2 * i}")(tokens))
            tokens = tokens + y
            y = sub(f"LayerNorm_{2 * i + 1}")(tokens)
            y = sub(f"Dense_{2 * i + 1}")(gelu(sub(f"Dense_{2 * i}")(y),
                                               exact=False))
            tokens = tokens + y
        return tokens

