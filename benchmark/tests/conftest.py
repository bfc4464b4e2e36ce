"""Tiny versions of the benchmark's cells for the CPU: the same
configuration and mix files at a few thousand Gaussians and 64x48 pixels,
run through the port's plain CPU path."""

import json
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 4099


def tiny_config(name: str, n: int = 1500, width: int = 64,
                height: int = 48) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(gaussians=n, width=width, height=height, views=9)
    cfg["assumed"]["focal_px"] = 60
    return cfg


def tiny_mix(name: str) -> dict:
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    if mix["driver"] == "train":
        mix.update(warmup_from=mix["start_iteration"] - 5, chunk=5)
    else:
        mix.update(trace_frames=4)
    return mix


# The training cells, which BENCHMARK.json leaves out while the program's
# fault (PERF.md, Open questions) stands: their files are kept, and a later
# PR lists them again.
TRAIN_CELLS = [
    {"name": "m360-mean-3m.train", "config": "m360-mean-3m",
     "traffic": "train_steady", "chips": 1},
    {"name": "tandt-truck-1.7m.train", "config": "tandt-truck-1.7m",
     "traffic": "train_steady", "chips": 1},
]


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def cuda_card():
    """Skips the test without a CUDA card (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
