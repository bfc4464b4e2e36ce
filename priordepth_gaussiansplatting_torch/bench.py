"""Rasterizer fwd+bwd throughput on one card (counterpart of the repo's root
``bench.py``).

    python -m priordepth_gaussiansplatting_torch.bench

The workload is ``bench.py``'s: ``PDGS_BENCH_N`` random Gaussians (default
1,000,000; ``utils/testing.py::random_gaussians``, scales 0.001-0.004, SH
degree 3) seen from (0, 0, -2.5) at 1600x1066 with antialiasing, and the
gradient of MSE against a seeded uniform target plus 0.01 x mean inverse
depth with respect to every Gaussian input, through the whole
differentiable path (projection, K1, the tile sort, K5a, K2; K3, K5b, K4,
the projection's backward). There is no optimizer. The pair capacities
follow ``bench.py``'s rule: one probe binning at the default capacity, then
the ladder rung above 1.05 times the rect pairs and the kept pairs. A step
that overflows them fails the run.

One step warms up; then a chain of 2 steps and a chain of 12 are timed on
the host clock, each ending in ``torch.cuda.synchronize()``, and a step is
their difference over 10, so the host's launch time counts as it does for
a user. ``vs_baseline`` divides by ``bench.py``'s 30e6 rays/s, an estimate
of the CUDA reference's fwd+bwd throughput on a 24 GB RTX card derived from
upstream 3DGS training-time reports, not a measurement.

Prints the card (``nvidia-smi`` name and power limit) with the capacities,
the pair counts and the kernel launches of the timed steps (warm-up
included), then, last, ``bench.py``'s JSON line: ``metric``,
``value``, ``unit``, ``vs_baseline``. A run that wedges prints that line
with value 0.0 and exits 3.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import torch

from .core import transforms
from .device import launch_counts, resolve_device
from .ops import binning
from .ops import projection as proj_ops
from .ops import rasterize as raster_ops
from .utils import testing

N_GAUSS = int(os.environ.get("PDGS_BENCH_N", 1_000_000))
WIDTH, HEIGHT = 1600, 1066
BASELINE_RAYS_PER_S = 30e6
ITERS = 10
HEADROOM = 1.05
EYE = (0.0, 0.0, -2.5)


def _watchdog(seconds: float, payload: dict) -> threading.Timer:
    """Print the failure line and hard-exit if the run has not finished
    within `seconds` (a wedged card must not hang the caller)."""
    def fire():
        print(json.dumps(payload), flush=True)
        os._exit(3)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def metric(n: int, width: int, height: int) -> str:
    return f"rays/s fwd+bwd, {n // 1000}k gaussians @{width}x{height}, 1 chip"


def result_line(n: int, width: int, height: int, rays_per_s: float) -> dict:
    """``bench.py``'s last line."""
    return {"metric": metric(n, width, height),
            "value": round(rays_per_s, 1), "unit": "rays/s",
            "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4)}


def capacities(num_rect: int, num_valid: int) -> tuple[int, int]:
    """(pair capacity, valid capacity): the ladder rung above HEADROOM times
    the probe's rect pairs and kept pairs (``bench.py:100-101``)."""
    return (raster_ops.round_capacity(int(num_rect * HEADROOM)),
            raster_ops.round_capacity(int(num_valid * HEADROOM)))


def project(params: dict, cam, width: int, height: int):
    cov3d = transforms.scaling_rotation_to_cov3d(params["scales"],
                                                 params["quats"])
    return proj_ops.project_gaussians(
        params["means"], cov3d, params["opacities"], params["sh"], 3,
        cam.world_view, cam.full_proj, cam.cam_center, width, height,
        cam.tan_fovx, cam.tan_fovy, antialiasing=True)


def loss_and_grads(params: dict, cam, target, width: int, height: int,
                   p_cap: int, v_cap: int):
    """The bench's loss and its gradient with respect to every tensor of
    `params`: (loss, {name: gradient}, the rasterizer's outputs)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        out = raster_ops.rasterize(
            project(leaves, cam, width, height),
            torch.zeros(3, device=target.device), width, height,
            pair_capacity=p_cap, valid_capacity=v_cap)
        loss = (((out["render"] - target) ** 2).mean()
                + 0.01 * out["invdepth"].mean())
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads)), out


def run(n: int, width: int, height: int, iters: int, device,
        seed: int = 0) -> dict:
    """Probe the capacities, then time fwd+bwd steps as ``bench.py`` does.
    Raises if any step overflows the capacities."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cam = testing.look_at_camera(EYE, width=width, height=height, device=dev)
    g = testing.random_gaussians(seed, n, extent=1.0,
                                 scale_range=(0.001, 0.004))
    params = {k: torch.as_tensor(v, device=dev) for k, v in g.items()}
    target = torch.rand(3, height, width, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed + 1))

    with torch.no_grad():
        _, aux = binning.bin_sorted_pairs(
            project(params, cam, width, height), width, height,
            raster_ops.default_pair_capacity(n))
    num_rect, num_valid = int(aux["num_rect"]), int(aux["num_valid"])
    p_cap, v_cap = capacities(num_rect, num_valid)

    def chain(k: int) -> float:
        """Seconds for k steps on the host clock; every step's overflow
        summed on the device and checked once the chain has finished."""
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        for _ in range(k):
            _, _, out = loss_and_grads(params, cam, target, width, height,
                                       p_cap, v_cap)
            overflow += out["overflow"]
        sync()
        seconds = time.perf_counter() - t0
        if int(overflow):
            raise RuntimeError(
                f"pairs overflowed the capacities (p_cap {p_cap}, v_cap "
                f"{v_cap}) by {int(overflow)} over {k} steps")
        return seconds

    before = launch_counts()
    chain(1)  # warm-up
    lo = chain(2)
    hi = chain(iters + 2)
    after = launch_counts()
    dt = max(hi - lo, 1e-9) / iters
    return {"device": str(dev), "n": n, "width": width, "height": height,
            "iters": iters, "num_rect": num_rect, "num_valid": num_valid,
            "p_cap": p_cap, "v_cap": v_cap, "overflow": 0,
            "steps": iters + 5,
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] > before[k]},
            "chain_s": [lo, hi], "ms_per_step": dt * 1e3,
            "rays_per_s": width * height / dt}


def main() -> int:
    dev = resolve_device(None)
    fail = dict(result_line(N_GAUSS, WIDTH, HEIGHT, 0.0),
                metric=metric(N_GAUSS, WIDTH, HEIGHT) + " (TIMED OUT)")
    # Health check: a trivial op must complete quickly on a live card.
    hc = _watchdog(180.0, fail)
    torch.ones(8, device=dev).sum().item()
    hc.cancel()
    wd = _watchdog(3000.0, fail)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    res = run(N_GAUSS, WIDTH, HEIGHT, ITERS, dev)
    wd.cancel()
    print(json.dumps({"nvidia_smi": smi[torch.cuda.current_device()],
                      **res}), flush=True)
    print(json.dumps(result_line(N_GAUSS, WIDTH, HEIGHT,
                                 res["rays_per_s"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
