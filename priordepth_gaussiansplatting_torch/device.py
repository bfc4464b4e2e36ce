"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch

from .kernels import launch_counts, reset_launch_counts  # noqa: F401


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card. Without a card that raises: nothing falls
    back to the CPU unless the caller passed ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
