"""torch ViT and ZoeDepth checkpoints -> the port's depth modules
(counterpart of the JAX package's ``depth/import_torch.py``, with the same
contract; its output is a torch state dict, not a flax tree).

It maps a timm (MiDaS), DINOv2 or DepthAnythingV2 ViT state dict
(``patch_embed`` / ``pos_embed`` / ``blocks.N.{norm1,attn.qkv,attn.proj,
norm2,mlp.fc1,mlp.fc2}``, with a ``pretrained.`` or ``core.core.`` prefix or
none) onto ``depth.model.ViTEncoder``, inferring the geometry (embed dim,
depth, heads, patch size, class and register tokens, LayerScale, final
norm) from the tensors (``zoedepth/models/model_io.py:27-91`` is the torch
side's loader), and a ZoeDepth metric-head state dict onto
``depth.model.MetricBinsHead``.

Notes:
  * the positional table is resampled bilinearly (antialiased when it
    shrinks, as ``jax.image.resize`` does) to the caller's inference grid
    and stored row-major in the encoder's ``pos_embed`` table, zero-padded
    (exact when inference runs at that grid);
  * torch ViTs use the exact erf GELU: build the encoder with
    ``exact_gelu=True``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .layers import resize_bilinear


def _np(t):
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_state_dict(path_or_dict) -> dict:
    """A state dict from a torch .pt/.pth file (or pass a dict through).

    Accepts the common wrappers (``{"model": sd}``, ``{"state_dict": sd}``)
    and strips ``module.`` DDP prefixes, like the reference
    ``model_io.load_state_dict`` (``zoedepth/models/model_io.py:27-52``).
    A file is unpickled in full: load only checkpoints you trust."""
    if isinstance(path_or_dict, Mapping):
        sd = dict(path_or_dict)
    else:
        sd = torch.load(path_or_dict, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict", "params"):
        if key in sd and isinstance(sd[key], Mapping):
            sd = dict(sd[key])
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def strip_prefix(sd: Mapping, prefix: str) -> dict:
    """Keep only keys under `prefix`, with the prefix removed.

    DepthAnythingV2 checkpoints store the DINOv2 backbone under
    ``pretrained.`` and the DPT head under ``depth_head.``; ZoeDepth stores
    the MiDaS backbone under ``core.core.``."""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def detect_backbone_prefix(sd: Mapping) -> str:
    """Find the ViT-backbone key prefix inside a composite checkpoint."""
    for prefix in ("", "pretrained.", "core.core.pretrained.model.",
                   "core.core."):
        if prefix + "patch_embed.proj.weight" in sd:
            return prefix
    raise KeyError("no ViT patch_embed found under known prefixes")


def infer_vit_geometry(sd: Mapping) -> dict:
    """(embed_dim, depth, num_heads, patch_size, mlp_ratio) plus the DINOv2
    feature flags (cls/register tokens, layerscale, final norm), inferred
    from tensor shapes and key presence."""
    pw = _np(sd["patch_embed.proj.weight"])  # (E, 3, p, p)
    embed_dim, _, patch, _ = pw.shape
    depth = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith("blocks."))
    fc1 = _np(sd["blocks.0.mlp.fc1.weight"])
    mlp_ratio = fc1.shape[0] // embed_dim
    regs = (_np(sd["register_tokens"]).shape[1]
            if "register_tokens" in sd else 0)
    # Heads are not recoverable from shapes: dim // 64 (every MiDaS, DAv2
    # and DINOv2 ViT has 64-dim heads).
    return dict(embed_dim=int(embed_dim), depth=int(depth),
                num_heads=max(int(embed_dim // 64), 1),
                patch_size=int(patch), mlp_ratio=int(mlp_ratio),
                use_cls_token="cls_token" in sd,
                num_register_tokens=int(regs),
                layerscale="blocks.0.ls1.gamma" in sd,
                final_norm="norm.weight" in sd)


def resample_pos_embed(pos, target_grid, drop_cls: bool = True
                       ) -> np.ndarray:
    """(1, N(+1), E) torch pos table -> (target_h*target_w, E), bilinear as
    ``jax.image.resize`` (antialiased when the grid shrinks).

    The torch table is a flattened square grid (optionally with a leading
    class token); the target grid is the inference patch grid."""
    pos = _np(pos)[0]
    if drop_cls and int(np.sqrt(pos.shape[0])) ** 2 != pos.shape[0]:
        pos = pos[1:]
    g = int(np.sqrt(pos.shape[0]))
    if g * g != pos.shape[0]:
        raise ValueError(f"pos table length {pos.shape[0]} is not square")
    th, tw = target_grid
    grid = torch.tensor(pos.reshape(g, g, -1), dtype=torch.float32)
    out = resize_bilinear(grid.permute(2, 0, 1)[None], (th, tw))
    return out[0].permute(1, 2, 0).reshape(th * tw, -1).numpy()


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(_np(x)), dtype=torch.float32)


def convert_vit_state_dict(sd: Mapping, target_grid=(24, 24),
                           pos_table_rows: int = 4096,
                           num_heads: int | None = None
                           ) -> tuple[dict, dict]:
    """timm-style ViT state dict -> the port's ``ViTEncoder`` state dict and
    geometry.

    Returns ``(state_dict, geometry)``; load the state dict into
    ``ViTEncoder(embed_dim, depth, num_heads, patch_size, pos_rows=
    pos_table_rows, exact_gelu=True, use_cls_token=..., ...)`` with the
    geometry's values. `num_heads` overrides the dim // 64 inference.

    A ``pretrained.`` (DAv2) backbone prefix is stripped, the class token
    keeps its own positional row, register tokens transfer verbatim,
    per-block LayerScale gammas map to ``ls{1,2}_{i}`` and the final
    ``norm`` to ``final_norm``."""
    sd = dict(sd)
    prefix = detect_backbone_prefix(sd)
    if prefix:
        sd = strip_prefix(sd, prefix)
    geo = infer_vit_geometry(sd)
    if num_heads is not None:
        geo["num_heads"] = int(num_heads)
    e = geo["embed_dim"]

    out: dict = {"Conv_0.weight": _f32(sd["patch_embed.proj.weight"]),
                 "Conv_0.bias": _f32(sd["patch_embed.proj.bias"])}
    pos = resample_pos_embed(sd["pos_embed"], target_grid)
    if pos.shape[0] > pos_table_rows:
        raise ValueError(f"target grid {tuple(target_grid)} needs "
                         f"{pos.shape[0]} positional rows, more than "
                         f"{pos_table_rows}")
    table = torch.zeros(1, pos_table_rows, e)
    table[0, :pos.shape[0]] = torch.from_numpy(pos)
    out["pos_embed"] = table
    if geo["use_cls_token"]:
        out["cls_token"] = _f32(sd["cls_token"]).reshape(1, 1, e)
        raw_pos = _np(sd["pos_embed"])[0]
        has_cls_pos = int(np.sqrt(raw_pos.shape[0])) ** 2 != raw_pos.shape[0]
        out["cls_pos_embed"] = (_f32(raw_pos[:1]).reshape(1, 1, e)
                                if has_cls_pos else torch.zeros(1, 1, e))
    if geo["num_register_tokens"]:
        out["register_tokens"] = _f32(sd["register_tokens"]).reshape(
            1, geo["num_register_tokens"], e)
    if geo["final_norm"]:
        out["final_norm.weight"] = _f32(sd["norm.weight"])
        out["final_norm.bias"] = _f32(sd["norm.bias"])

    def lin(dst: str, src: str):
        out[dst + ".weight"] = _f32(sd[src + ".weight"])
        out[dst + ".bias"] = _f32(sd[src + ".bias"])

    for i in range(geo["depth"]):
        pre = f"blocks.{i}."
        if geo["layerscale"]:
            out[f"ls1_{i}"] = _f32(sd[pre + "ls1.gamma"])
            out[f"ls2_{i}"] = _f32(sd[pre + "ls2.gamma"])
        lin(f"LayerNorm_{2 * i}", pre + "norm1")
        qkv_w = _f32(sd[pre + "attn.qkv.weight"])  # (3E, E)
        qkv_b = _f32(sd[pre + "attn.qkv.bias"])
        for j, name in enumerate(("query", "key", "value")):
            att = f"SelfAttention_{i}.{name}"
            out[att + ".weight"] = qkv_w[j * e:(j + 1) * e].clone()
            out[att + ".bias"] = qkv_b[j * e:(j + 1) * e].clone()
        lin(f"SelfAttention_{i}.out", pre + "attn.proj")
        lin(f"LayerNorm_{2 * i + 1}", pre + "norm2")
        lin(f"Dense_{2 * i}", pre + "mlp.fc1")
        lin(f"Dense_{2 * i + 1}", pre + "mlp.fc2")
    return out, geo


def convert_zoedepth_head_state_dict(sd: Mapping) -> tuple[dict, dict]:
    """torch ZoeDepth metric-head state dict -> the port's
    ``MetricBinsHead`` state dict and geometry.

    Maps the reference head modules (``zoedepth_v1.py:105-122``: ``conv2``,
    ``seed_bin_regressor``, ``seed_projector``, ``projectors.{i}``,
    ``attractors.{i}``, ``conditional_log_binomial``, each a Conv/act/Conv
    ``_net``/``mlp`` Sequential) onto ``conv2``, ``seed_bin_regressor``,
    ``seed_projector``, ``projector_{i}``, ``attractor_{i}`` and
    ``conditional_log_binomial``. The geometry carries n_bins,
    bin_embedding_dim, btlnck_features and attractors from the shapes."""
    out: dict = {}

    def conv(dst: str, src: str):
        out[dst + ".weight"] = _f32(sd[src + ".weight"])
        out[dst + ".bias"] = _f32(sd[src + ".bias"])

    def net(dst: str, src: str):
        conv(dst + ".Conv_0", src + ".0")
        conv(dst + ".Conv_1", src + ".2")

    conv("conv2", "conv2")
    net("seed_bin_regressor", "seed_bin_regressor._net")
    net("seed_projector", "seed_projector._net")
    net("conditional_log_binomial", "conditional_log_binomial.mlp")
    n_levels = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("projectors."))
    attractors = []
    for i in range(n_levels):
        net(f"projector_{i}", f"projectors.{i}._net")
        net(f"attractor_{i}", f"attractors.{i}._net")
        attractors.append(int(_np(sd[f"attractors.{i}._net.2.weight"])
                              .shape[0]))
    geo = dict(
        n_bins=int(_np(sd["seed_bin_regressor._net.2.weight"]).shape[0]),
        bin_embedding_dim=int(_np(sd["seed_projector._net.2.weight"])
                              .shape[0]),
        btlnck_features=int(_np(sd["conv2.weight"]).shape[0]),
        attractors=tuple(attractors),
    )
    return out, geo


def graft_encoder_params(model_state: Mapping, vit_state: Mapping,
                         scope: str = "ViTEncoder_0") -> dict:
    """A copy of a DepthModel(NK) state dict with its encoder's entries
    (those under ``scope.``) replaced by `vit_state`'s.

    Names and shapes are checked entry by entry, so a geometry mismatch
    fails loudly, naming the entry, instead of leaving a half-loaded
    model."""
    pre = scope + "."
    old = {k[len(pre):]: v for k, v in model_state.items()
           if k.startswith(pre)}
    if not old:
        scopes = sorted({k.split(".")[0] for k in model_state})
        raise KeyError(f"{scope} not in the model's state (have {scopes})")
    if set(old) != set(vit_state):
        raise ValueError(
            "encoder geometry mismatch: the model's "
            f"{sorted(set(old) - set(vit_state))} are not in the "
            f"checkpoint, whose {sorted(set(vit_state) - set(old))} the "
            "model lacks")
    for k, v in vit_state.items():
        if tuple(old[k].shape) != tuple(v.shape):
            raise ValueError(f"encoder geometry mismatch at {pre}{k}: model "
                             f"{tuple(old[k].shape)}, checkpoint "
                             f"{tuple(v.shape)}")
    out = dict(model_state)
    out.update({pre + k: v for k, v in vit_state.items()})
    return out
