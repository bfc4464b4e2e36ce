"""Metric monodepth models: ViT encoder + DPT-style decoder + metric-bins
head, with a two-expert router variant (counterpart of the JAX package's
``depth/model.py``; reference ``zoedepth/models/{base_models/midas.py,
zoedepth/zoedepth_v1.py, zoedepth_nk/zoedepth_nk_v1.py}``).

Layout: images are (B, 3, H, W) in [0, 1], feature maps NCHW, bin
probabilities and centres (B, n_bins, h, w); depths (B, H, W). Submodules
carry flax's names for the JAX modules' parameters (``ViTEncoder_0``,
``DPTDecoder_0``, ``MetricBinsHead_0``, ``head_nyu``, ...), so
``interop.depth_module_from_numpy`` carries a JAX model's weights across.
Make a model with ``layers.build`` (or ``config.build_model``), which
draws its weights from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (ConditionalLogBinomial, PatchTransformerEncoder,
                     Projector, SelfAttention, AttractorLayer,
                     AttractorLayerUnnormed, SeedBinRegressor,
                     SeedBinRegressorUnnormed, conv, gelu,
                     resize_align_corners, resize_bilinear)


class ViTEncoder(nn.Module):
    """Plain ViT encoder with patch tokens reassembled to feature grids:
    (B, 3, H, W), H and W divisible by the patch, -> a list of
    (B, E, H/p, W/p), one per tap in ``taps`` and the last block's.

    The options of the JAX encoder: ``exact_gelu`` (the erf GELU of torch
    checkpoints; tanh otherwise), ``ln_eps`` (torch's 1e-5), a positional
    table of ``pos_rows`` rows sliced per input size (more patches than
    rows raise), and DINOv2's geometry: a class token with its own
    positional row, register tokens inserted after the positional add,
    per-block LayerScale and ``final_norm`` on every tap."""

    def __init__(self, embed_dim: int = 384, depth: int = 6,
                 num_heads: int = 0, patch_size: int = 16,
                 taps: Sequence[int] = (1, 3, 5), exact_gelu: bool = False,
                 pos_rows: int = 4096, use_cls_token: bool = False,
                 num_register_tokens: int = 0, layerscale: bool = False,
                 final_norm: bool = False, ln_eps: float = 1e-5):
        super().__init__()
        e = embed_dim
        self.embed_dim, self.depth, self.patch_size = e, depth, patch_size
        self.taps, self.exact_gelu = tuple(taps), exact_gelu
        self.layerscale = layerscale
        self.n_extra = int(use_cls_token) + num_register_tokens
        self.Conv_0 = nn.Conv2d(3, e, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.empty(1, pos_rows, e))
        if use_cls_token:
            self.cls_token = nn.Parameter(torch.empty(1, 1, e))
            self.cls_pos_embed = nn.Parameter(torch.empty(1, 1, e))
        if num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.empty(1, num_register_tokens, e))
        self.final_norm = (nn.LayerNorm(e, eps=ln_eps) if final_norm
                           else None)
        heads = num_heads or max(e // 64, 1)
        for i in range(depth):
            self.add_module(f"LayerNorm_{2 * i}", nn.LayerNorm(e, eps=ln_eps))
            self.add_module(f"SelfAttention_{i}", SelfAttention(e, heads))
            self.add_module(f"LayerNorm_{2 * i + 1}",
                            nn.LayerNorm(e, eps=ln_eps))
            self.add_module(f"Dense_{2 * i}", nn.Linear(e, 4 * e))
            self.add_module(f"Dense_{2 * i + 1}", nn.Linear(4 * e, e))
            if layerscale:
                self.register_parameter(f"ls1_{i}",
                                        nn.Parameter(torch.empty(e)))
                self.register_parameter(f"ls2_{i}",
                                        nn.Parameter(torch.empty(e)))

    def forward(self, x):
        p = self.patch_size
        b, _, h, w = x.shape
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} is not divisible by the patch "
                             f"size {p}")
        gh, gw = h // p, w // p
        rows = self.pos_embed.shape[1]
        if gh * gw > rows:
            side = math.isqrt(rows) * p
            raise ValueError(
                f"input {h}x{w} makes {gh}x{gw} = {gh * gw} patches, more "
                f"than the positional table's {rows} rows (at most "
                f"{side}x{side} px at patch {p})")
        tok = self.Conv_0(x).flatten(2).transpose(1, 2)
        tok = tok + self.pos_embed[:, :gh * gw]
        if hasattr(self, "cls_token"):
            cls = (self.cls_token + self.cls_pos_embed).expand(b, -1, -1)
            tok = torch.cat([cls, tok], dim=1)
        if hasattr(self, "register_tokens"):
            # Registers sit between the class token and the patches, with
            # no positional row.
            k = int(hasattr(self, "cls_token"))
            tok = torch.cat([tok[:, :k],
                             self.register_tokens.expand(b, -1, -1),
                             tok[:, k:]], dim=1)
        sub = self.get_submodule

        def spatial(z):
            z = z[:, self.n_extra:]
            if self.final_norm is not None:
                z = self.final_norm(z)
            return z.transpose(1, 2).reshape(b, self.embed_dim, gh, gw)

        feats = []
        for i in range(self.depth):
            y = sub(f"SelfAttention_{i}")(sub(f"LayerNorm_{2 * i}")(tok))
            if self.layerscale:
                y = y * getattr(self, f"ls1_{i}")
            tok = tok + y
            y = sub(f"LayerNorm_{2 * i + 1}")(tok)
            y = gelu(sub(f"Dense_{2 * i}")(y), exact=self.exact_gelu)
            y = sub(f"Dense_{2 * i + 1}")(y)
            if self.layerscale:
                y = y * getattr(self, f"ls2_{i}")
            tok = tok + y
            if i in self.taps:
                feats.append(spatial(tok))
        feats.append(spatial(tok))
        return feats  # low -> high depth


class DPTDecoder(nn.Module):
    """Fusion decoder producing the MidasCore-style multi-scale taps:
    `n_feats` encoder maps of `in_channels` -> (relative depth (B, H/2,
    W/2), [l4_rn, r4, r3, r2, out] of `features` channels)."""

    def __init__(self, in_channels: int, n_feats: int = 4,
                 features: int = 128):
        super().__init__()
        self.n_feats = n_feats
        for j in range(n_feats):
            self.add_module(f"Conv_{2 * j}", conv(in_channels, features, 3))
            self.add_module(f"Conv_{2 * j + 1}", conv(features, features, 3))
        self.add_module(f"Conv_{2 * n_feats}", conv(features, features, 3))
        self.add_module(f"Conv_{2 * n_feats + 1}", conv(features, 1))

    def forward(self, enc_feats, out_hw):
        if len(enc_feats) != self.n_feats:
            raise ValueError(f"{len(enc_feats)} encoder maps for a decoder "
                             f"of {self.n_feats}")
        sub, n = self.get_submodule, self.n_feats
        x, taps = None, []
        for j, feat in enumerate(reversed(enc_feats)):
            f = sub(f"Conv_{2 * j}")(feat)
            x = f if x is None else resize_bilinear(x, f.shape[-2:]) + f
            x = F.relu(sub(f"Conv_{2 * j + 1}")(x))
            taps.append(x)
        out = resize_bilinear(x, (out_hw[0] // 2, out_hw[1] // 2))
        out = F.relu(sub(f"Conv_{2 * n}")(out))
        rel_depth = sub(f"Conv_{2 * n + 1}")(out)[:, 0]
        return rel_depth, [*taps, out]


class MetricBinsHead(nn.Module):
    """Seed bins -> per-level attractor refinement -> log-binomial -> depth
    (``zoedepth_v1.py:124-202``): a bottleneck 1x1 conv, a seed projector
    feeding a ``prev_b_embedding`` chain through the attractors, and the
    relative depth concatenated onto the finest map before the conditional
    log-binomial. `tap_channels` are the channels of the taps it is given
    ([bottleneck, level maps..., last]); ``rel_depth`` whether a relative
    depth map comes with them."""

    def __init__(self, tap_channels: Sequence[int], n_bins: int = 16,
                 bin_embedding_dim: int = 128, min_depth: float = 1e-3,
                 max_depth: float = 10.0,
                 attractors: Sequence[int] = (16, 8, 4, 1),
                 bin_centers_type: str = "softplus",
                 attractor_alpha: float = 1000.0, attractor_gamma: int = 2,
                 attractor_kind: str = "mean", attractor_type: str = "inv",
                 min_temp: float = 0.0212, max_temp: float = 50.0,
                 btlnck_features: int = 0, rel_depth: bool = True):
        super().__init__()
        tap_channels = tuple(tap_channels)
        self.min_depth, self.max_depth = min_depth, max_depth
        self.normed = bin_centers_type == "normed"
        c = btlnck_features or tap_channels[0]
        self.conv2 = conv(tap_channels[0], c)
        seed = SeedBinRegressor if self.normed else SeedBinRegressorUnnormed
        self.seed_bin_regressor = seed(c, n_bins=n_bins, min_depth=min_depth,
                                       max_depth=max_depth)
        self.seed_projector = Projector(c, out_features=bin_embedding_dim)
        att = AttractorLayer if self.normed else AttractorLayerUnnormed
        self.n_levels = min(len(attractors), len(tap_channels) - 1)
        for level in range(self.n_levels):
            self.add_module(f"projector_{level}", Projector(
                tap_channels[level + 1], out_features=bin_embedding_dim))
            self.add_module(f"attractor_{level}", att(
                bin_embedding_dim, n_bins=n_bins,
                n_attractors=attractors[level], alpha=attractor_alpha,
                gamma=attractor_gamma, kind=attractor_kind,
                attractor_type=attractor_type, min_depth=min_depth,
                max_depth=max_depth))
        self.conditional_log_binomial = ConditionalLogBinomial(
            tap_channels[-1] + int(rel_depth) + bin_embedding_dim,
            n_bins=n_bins, min_temp=min_temp, max_temp=max_temp)

    def forward(self, taps, rel_depth=None):
        x = self.conv2(taps[0])
        _, seed_centers = self.seed_bin_regressor(x)
        b_prev = ((seed_centers - self.min_depth)
                  / (self.max_depth - self.min_depth)
                  if self.normed else seed_centers)
        prev_emb = self.seed_projector(x)
        centers = seed_centers
        for level in range(self.n_levels):
            emb = self.get_submodule(f"projector_{level}")(taps[level + 1])
            b_prev, centers = self.get_submodule(f"attractor_{level}")(
                emb, b_prev, prev_emb)
            prev_emb = emb
        last = taps[-1]
        if rel_depth is not None:
            rel = resize_align_corners(rel_depth[:, None], last.shape[-2:])
            last = torch.cat([last, rel], dim=1)
        cond = resize_align_corners(prev_emb, last.shape[-2:])
        probs = self.conditional_log_binomial(last, cond)
        centers = resize_align_corners(centers, probs.shape[-2:])
        depth = torch.sum(probs * centers, dim=1)  # (B, h, w)
        return depth, probs, centers


# The decoder's width and tap count, and what the head sees of them.
DECODER_FEATURES = 128
ENCODER_TAPS = (1, 3, 5)


def _core(embed_dim: int, encoder_depth: int):
    """The encoder, the decoder and the channels of the decoder's taps: one
    map per encoder tap inside its depth and the last block's, and the
    decoder's output."""
    n_feats = sum(t < encoder_depth for t in ENCODER_TAPS) + 1
    enc = ViTEncoder(embed_dim=embed_dim, depth=encoder_depth,
                     taps=ENCODER_TAPS)
    dec = DPTDecoder(embed_dim, n_feats=n_feats, features=DECODER_FEATURES)
    return enc, dec, (DECODER_FEATURES,) * (n_feats + 1)


class DepthModel(nn.Module):
    """Single-head metric depth model (ZoeDepth-style): (B, 3, H, W) in
    [0, 1] -> {metric_depth (B, H, W), rel_depth (B, H/2, W/2), probs and
    bin_centers (B, n_bins, H/2, W/2)}."""

    def __init__(self, min_depth: float = 1e-3, max_depth: float = 10.0,
                 n_bins: int = 16, embed_dim: int = 384,
                 encoder_depth: int = 6, bin_centers_type: str = "softplus"):
        super().__init__()
        self.ViTEncoder_0, self.DPTDecoder_0, taps = _core(embed_dim,
                                                           encoder_depth)
        self.MetricBinsHead_0 = MetricBinsHead(
            taps, n_bins=n_bins, min_depth=min_depth, max_depth=max_depth,
            bin_centers_type=bin_centers_type)

    def forward(self, x):
        feats = self.ViTEncoder_0(x)
        rel_depth, taps = self.DPTDecoder_0(feats, x.shape[-2:])
        depth, probs, centers = self.MetricBinsHead_0(taps, rel_depth)
        depth = resize_bilinear(depth[:, None], x.shape[-2:])[:, 0]
        return {"metric_depth": depth, "rel_depth": rel_depth,
                "probs": probs, "bin_centers": centers}


class DepthModelNK(nn.Module):
    """Two-expert variant with a learned patch-transformer router
    (``zoedepth_nk_v1.py``): one head per depth-range config, routed by the
    class token (``hard_route`` at inference, a soft mix while training).
    -> {metric_depth, rel_depth, domain_logits (B, len(configs))}."""

    def __init__(self, configs: Sequence[dict] = (
            dict(name="nyu", min_depth=1e-3, max_depth=10.0),
            dict(name="kitti", min_depth=1e-3, max_depth=80.0)),
            n_bins: int = 16, embed_dim: int = 384, encoder_depth: int = 6,
            bin_centers_type: str = "softplus"):
        super().__init__()
        self.names = [cfg["name"] for cfg in configs]
        self.ViTEncoder_0, self.DPTDecoder_0, taps = _core(embed_dim,
                                                           encoder_depth)
        router = self.PatchTransformerEncoder_0 = PatchTransformerEncoder(
            taps[0])
        self.Dense_0 = nn.Linear(router.embed_dim, len(configs))
        for cfg in configs:
            self.add_module(f"head_{cfg['name']}", MetricBinsHead(
                taps, n_bins=n_bins, min_depth=cfg["min_depth"],
                max_depth=cfg["max_depth"],
                bin_centers_type=bin_centers_type))

    def forward(self, x, hard_route: bool = False):
        feats = self.ViTEncoder_0(x)
        rel_depth, taps = self.DPTDecoder_0(feats, x.shape[-2:])
        tokens = self.PatchTransformerEncoder_0(taps[0])
        logits = self.Dense_0(tokens[:, 0])  # (B, experts)
        route = torch.softmax(logits, dim=-1)
        depths = []
        for name in self.names:
            d, _, _ = self.get_submodule(f"head_{name}")(taps, rel_depth)
            depths.append(resize_bilinear(d[:, None], x.shape[-2:])[:, 0])
        stacked = torch.stack(depths, dim=-1)  # (B, H, W, experts)
        if hard_route:
            sel = torch.argmax(route, dim=-1)
            depth = torch.take_along_dim(
                stacked, sel[:, None, None, None], dim=-1)[..., 0]
        else:
            depth = torch.sum(stacked * route[:, None, None, :], dim=-1)
        return {"metric_depth": depth, "rel_depth": rel_depth,
                "domain_logits": logits}
