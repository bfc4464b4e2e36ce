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
