"""Config / CLI system: dataclass fields become argparse flags, and
``<model>/cfg_args`` keeps the reference's Namespace-repr format (a copy of
the JAX package's ``utils/config.py`` with the port's defaults).

Port differences: ``data_device`` names the device the whole render runs
on, ``"cuda"`` (the default; any value other than ``"cpu"``, such as a
``"tpu"`` saved by the JAX trainer, means the card) or ``"cpu"``; and
``backend`` is one of ``auto`` (kernels on the card, the dense oracle on the
CPU), ``kernels`` (the tile pipeline; its plain PyTorch versions on the CPU)
or ``oracle``.
"""

from __future__ import annotations

import dataclasses
import os
from argparse import ArgumentParser, Namespace
from typing import Optional

BACKENDS = ("auto", "kernels", "oracle")


@dataclasses.dataclass
class ModelConfig:
    """Reference `ModelParams`."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    depths: str = ""
    resolution: int = -1
    white_background: bool = False
    train_test_exp: bool = False
    data_device: str = "cuda"
    eval: bool = False


@dataclasses.dataclass
class PipelineConfig:
    """Reference `PipelineParams`, plus the rasterizer backend."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    antialiasing: bool = False
    backend: str = "auto"


@dataclasses.dataclass
class OptimizationConfig:
    """Reference `OptimizationParams`."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.025
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    exposure_lr_init: float = 0.01
    exposure_lr_final: float = 0.001
    exposure_lr_delay_steps: int = 0
    exposure_lr_delay_mult: float = 0.0
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01
    random_background: bool = False
    optimizer_type: str = "default"  # "default" | "sparse_adam"
    # The reference's train.py hard-codes is_depth_feedback=False.
    depth_feedback: bool = False
    # PriorDepth thesis events: noise-Gaussian injection and the depth-prior
    # floating-object prune loop (0 disables them).
    noise_injection_iter: int = 30_000
    floating_prune_iter: int = 40_000


SHORTHAND = {
    "source_path": "s",
    "model_path": "m",
    "images": "i",
    "depths": "d",
    "resolution": "r",
    "white_background": "w",
}


def torch_device_name(data_device: str) -> str:
    """``data_device`` as a torch device name: ``cpu`` or ``cuda``."""
    return "cpu" if data_device == "cpu" else "cuda"


def add_dataclass_args(parser: ArgumentParser, cfg, prefix: str = "") -> None:
    """Reflection over dataclass fields -> argparse flags."""
    group = parser.add_argument_group(type(cfg).__name__)
    for f in dataclasses.fields(cfg):
        default = getattr(cfg, f.name)
        names = [f"--{prefix}{f.name}"]
        if f.name in SHORTHAND:
            names.append(f"-{SHORTHAND[f.name]}")
        if isinstance(default, bool):
            group.add_argument(*names, action="store_true", default=default)
        elif f.name == "backend":
            group.add_argument(*names, choices=BACKENDS, default=default)
        else:
            group.add_argument(*names, type=type(default), default=default)


def extract_dataclass(cls, args: Namespace):
    kw = {f.name: getattr(args, f.name)
          for f in dataclasses.fields(cls) if hasattr(args, f.name)}
    return cls(**kw)


def save_cfg_args(model_path: str, model_cfg: ModelConfig) -> None:
    """Write `<model>/cfg_args` in the reference's Namespace-repr format."""
    os.makedirs(model_path, exist_ok=True)
    ns = Namespace(**dataclasses.asdict(model_cfg))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(ns))


def load_cfg_args(model_path: str) -> Optional[Namespace]:
    path = os.path.join(model_path, "cfg_args")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return eval(f.read(), {"Namespace": Namespace})  # noqa: S307 — format contract


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """CLI merged over saved cfg_args (CLI wins)."""
    args_cmd = parser.parse_args(argv)
    merged = vars(args_cmd).copy()
    saved = load_cfg_args(getattr(args_cmd, "model_path", "") or "")
    if saved is not None:
        defaults = {a.dest: parser.get_default(a.dest)
                    for a in parser._actions}
        for k, v in vars(saved).items():
            if k not in merged or merged[k] == defaults.get(k):
                merged[k] = v
    return Namespace(**merged)
