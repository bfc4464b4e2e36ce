"""Layered config merge for the depth subsystem (copy of the JAX package's
``depth/config.py``; reference ``zoedepth/utils/config.py:354-434``):
COMMON → dataset → model → mode → overrides, dict-based with attribute
access. ``build_model`` returns the port's modules."""

from __future__ import annotations

from typing import Dict


class ConfigDict(dict):
    """Attribute-access dict (the reference's EasyDict)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


COMMON_CONFIG = dict(
    model="depth", min_depth=1e-3, max_depth=10.0, n_bins=16,
    embed_dim=384, encoder_depth=6, bin_centers_type="softplus",
)

DATASETS_CONFIG: Dict[str, dict] = {
    "nyu": dict(min_depth=1e-3, max_depth=10.0, eigen_crop=True,
                min_depth_eval=1e-3, max_depth_eval=10.0),
    "kitti": dict(min_depth=1e-3, max_depth=80.0, garg_crop=True,
                  min_depth_eval=1e-3, max_depth_eval=80.0),
    "mix": dict(min_depth=1e-3, max_depth=80.0),
}

COMMON_TRAINING_CONFIG = dict(
    lr=1.61e-4, weight_decay=0.01, epochs=5, batch_size=16,
    w_grad=0.5, w_domain=0.1,
)

MODEL_CONFIGS: Dict[str, dict] = {
    "depth": dict(),
    "depth_nk": dict(model="depth_nk"),
}


def flatten(d: dict, parent: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{parent}{k}."))
        else:
            out[f"{parent}{k}"] = v
    return out


def get_config(model: str = "depth", mode: str = "train",
               dataset: str = "nyu", **overrides) -> ConfigDict:
    cfg = dict(COMMON_CONFIG)
    cfg.update(DATASETS_CONFIG.get(dataset, {}))
    cfg.update(MODEL_CONFIGS.get(model, {}))
    if mode == "train":
        cfg.update(COMMON_TRAINING_CONFIG)
    cfg.update(overrides)
    cfg["mode"] = mode
    cfg["dataset"] = dataset
    return ConfigDict(cfg)


def build_model(config: ConfigDict, generator=None, device=None):
    """Dynamic model construction (reference ``models/builder.py``): the
    port's module, its weights drawn from `generator` on `device` (the card
    unless the caller names the CPU)."""
    from .layers import build  # noqa: PLC0415
    from .model import DepthModel, DepthModelNK  # noqa: PLC0415
    common = dict(n_bins=config.n_bins, embed_dim=config.embed_dim,
                  encoder_depth=config.encoder_depth,
                  bin_centers_type=config.get("bin_centers_type",
                                              "softplus"),
                  generator=generator, device=device)
    if config.model == "depth_nk":
        return build(DepthModelNK, **common)
    return build(DepthModel, min_depth=config.min_depth,
                 max_depth=config.max_depth, **common)
