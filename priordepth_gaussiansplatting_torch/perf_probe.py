"""Stage-by-stage timing of the render path (counterpart of the repo's
``tools/perf_probe.py``).

    python -m priordepth_gaussiansplatting_torch.perf_probe [n] [w h]
        [--device cpu]

Random Gaussians (``utils/testing.py``, seed 0, scales 0.001-0.004, SH
degree 3, antialiasing on) seen from (0, 0, -2.5) at w x h. Stages:
``project``; ``bin+sort`` (``ops/binning.py::bin_gaussians``: depth order,
K7, the tile sort); ``full fwd`` (``ops/rasterize.py::rasterize``: K1, K5a,
K2); ``full fwd+bwd`` (the gradient of MSE against a random target plus
0.01 x mean inverse depth with respect to every Gaussian input: K3, K5b,
K4 too). Each stage runs once to warm up, then 10 times; on the card the
10 are timed with CUDA events. Prints one line per stage, the pair count,
rays/s and the kernel launches of each stage (warm-up included), then,
last, all of it as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .core import transforms
from .device import launch_counts, resolve_device
from .ops import binning
from .ops import projection as proj_ops
from .ops import rasterize as raster_ops
from .utils import testing

ITERS = 10


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("size", nargs="*", type=int,
                        help="[n_gaussians] [width height] (default 200000 "
                             "1600 1066)")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the card)")
    args = parser.parse_args(argv)
    if len(args.size) not in (0, 1, 3):
        parser.error("give n, or n w h")
    n, w, h = (list(args.size) + [200_000, 1600, 1066][len(args.size):])
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    print(f"device={dev} n={n} res={w}x{h}", flush=True)
    cam = testing.look_at_camera((0, 0, -2.5), width=w, height=h, device=dev)
    g = testing.random_gaussians(0, n, extent=1.0, scale_range=(0.001, 0.004))
    params = {k: torch.as_tensor(v, device=dev) for k, v in g.items()}
    target = torch.rand(3, h, w, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    bg = torch.zeros(3, device=dev)

    def project(p):
        cov3d = transforms.scaling_rotation_to_cov3d(p["scales"], p["quats"])
        return proj_ops.project_gaussians(
            p["means"], cov3d, p["opacities"], p["sh"], 3, cam.world_view,
            cam.full_proj, cam.cam_center, w, h, cam.tan_fovx, cam.tan_fovy,
            antialiasing=True)

    stages = {}

    def bench(name, fn, *a):
        before = launch_counts()
        r = fn(*a)
        sync()
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                r = fn(*a)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / ITERS
        else:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                r = fn(*a)
            ms = (time.perf_counter() - t0) * 1e3 / ITERS
        after = launch_counts()
        stages[name] = {"ms": ms, "calls": ITERS + 1, "launches": {
            k: after[k] - before[k] for k in after if after[k] > before[k]}}
        print(f"{name:<24} {ms:8.3f} ms", flush=True)
        return r

    p_cap = raster_ops.default_pair_capacity(n)
    with torch.no_grad():
        proj = bench("project", project, params)
        binned = bench("bin+sort", lambda pr: binning.bin_gaussians(
            pr, w, h, p_cap), proj)
        pairs, overflow = int(binned.num_pairs), int(binned.overflow)
        print(f"pairs={pairs} overflow={overflow}", flush=True)
        bench("full fwd", lambda p: raster_ops.rasterize(
            project(p), bg, w, h)["render"], params)

    leaves = [v.detach().requires_grad_(True) for v in params.values()]

    def fwd_bwd():
        out = raster_ops.rasterize(project(dict(zip(params, leaves))), bg,
                                   w, h)
        loss = (((out["render"] - target) ** 2).mean()
                + 0.01 * out["invdepth"].mean())
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    bench("full fwd+bwd", fwd_bwd)
    fwd = w * h / (stages["full fwd"]["ms"] * 1e-3)
    full = w * h / (stages["full fwd+bwd"]["ms"] * 1e-3)
    print(f"rays/s fwd      = {fwd:12.0f}", flush=True)
    print(f"rays/s fwd+bwd  = {full:12.0f}", flush=True)
    for name, st in stages.items():
        print(f"launches {name:<15} {json.dumps(st['launches'])}", flush=True)
    result = {"device": str(dev), "n": n, "width": w, "height": h,
              "pair_capacity": p_cap, "pairs": pairs, "overflow": overflow,
              "iters": ITERS, "stages": stages, "rays_per_s_fwd": fwd,
              "rays_per_s_fwd_bwd": full}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
