"""The general traffic generator. A mix's data file
(``benchmark/traffic/<mix>.json``) names its driver, the kind of traffic
it is, by ``"driver"``; the driver is the module of that name in this
package, which exports its class as ``DRIVER``. A new kind of traffic is
a new module here, a new mix of a known kind a new data file: neither
edits a file that is there.

A driver builds its inputs from the seed (``inputs.py``) and the
configuration (``benchmark/configs/<config>.json``), hands them to the
program through the program's own entry points, runs the measured window
or the traced span, and after the window has the reference judge what the
timed path produced (:meth:`Driver.check`). What a driver offers the
harness and ``control.py``:

  setup()            inputs, the program's state, warm-up (set-up time)
  window(seconds)    the measured window: units, failed, window_s,
                     latencies
  span(tracer)       the traced span, inside `tracer`
  release()          free the program's state
  check()            {number: value}, each compared with its limit
  controls()         {control or fault: {number: value}}, the readings a
                     limit's upper end is set from
  span_stats()       {view: [counted stats, times used]} of the span
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import torch

from .. import counts, inputs
from ..reference import render as rr


def load(kind: str):
    """The driver class of the traffic kind `kind` (module
    ``benchmark/drivers/<kind>.py``)."""
    return importlib.import_module(f"{__name__}.{kind}").DRIVER


def _port():
    """The measured program's modules (imported only when a run starts)."""
    from priordepth_gaussiansplatting_torch.core import cameras
    from priordepth_gaussiansplatting_torch.models import gaussians
    from priordepth_gaussiansplatting_torch.ops import rasterize, render
    from priordepth_gaussiansplatting_torch.train import optim, step, trainer
    from priordepth_gaussiansplatting_torch.utils import config
    return dict(cameras=cameras, gaussians=gaussians, rasterize=rasterize,
                render=render, optim=optim, step=step, trainer=trainer,
                config=config)


class Driver:
    """What the drivers share: the seeded inputs and the store."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.poses = inputs.poses(cfg, seed)
        self.extent = inputs.extent(self.poses)
        self.train_idx, self.test_idx = inputs.split(cfg)
        self.units = 0
        self.failed = 0
        self.window_s = 0.0
        self.latencies = []
        self.span_views = []
        self.p = _port()

    def camera(self, index: int, with_target: bool):
        pose = self.poses[index]
        cam = self.p["cameras"].make_camera(
            pose["R"], pose["t"], pose["fovx"], pose["fovy"], pose["width"],
            pose["height"], image_name=pose["name"], uid=index,
            device=self.device)
        if with_target:
            cam = dataclasses.replace(
                cam, image=inputs.target(self.cfg, self.seed, index,
                                         self.device),
                invdepth=inputs.prior(self.cfg, self.seed, index,
                                      self.device))
        return cam

    def view(self, index: int) -> dict:
        """The reference's own view matrices of view `index`."""
        p = self.poses[index]
        return rr.view_matrices(p["R"], p["t"], p["fovx"], p["fovy"],
                                p["width"], p["height"], self.device)

    def store_params(self) -> dict:
        return {k: inputs.leaf(self.cfg, self.seed, k, self.device)
                for k in inputs.LEAVES}

    def state(self, exposures: int):
        gm = self.p["gaussians"]
        params = self.store_params()
        n = params["xyz"].shape[0]
        params["exposure"] = torch.eye(3, 4, device=self.device)[None].repeat(
            max(exposures, 1), 1, 1)
        return gm.GaussianState(
            params=gm.GaussianParams(**params),
            active=torch.ones(n, dtype=torch.bool, device=self.device),
            active_sh_degree=self.cfg["sh_degree"],
            max_sh_degree=self.cfg["sh_degree"],
            spatial_lr_scale=self.extent)

    def bg(self, dtype=torch.float32) -> torch.Tensor:
        v = 1.0 if self.cfg["white_background"] else 0.0
        return torch.full((3,), v, device=self.device, dtype=dtype)

    def span_store(self) -> dict:
        """The store the traced span started from."""
        return self.store_params()

    def span_stats(self) -> dict:
        """Per distinct view of the traced span: its counted stats
        (``counts.view_stats``), and how many of the span's units used
        it."""
        params = self.span_store()
        out = {}
        for v in self.span_views:
            if v not in out:
                out[v] = [counts.view_stats(params, self.view(v),
                                            self.cfg["sh_degree"]), 0]
            out[v][1] += 1
        return out


def to_levels(image: torch.Tensor) -> torch.Tensor:
    """A (3, H, W) image in [0, 1] as the render CLI writes it: (H, W, 3)
    uint8 levels, truncated."""
    return (torch.clamp(image, 0, 1) * 255).to(torch.uint8).permute(1, 2, 0)


def level_gap(levels: torch.Tensor, ref: torch.Tensor,
              spare: float = 0.0) -> float:
    """The gap, in 1/255 levels, that all but the worst `spare` share of the
    image's pixels stay within: the (floor(spare x pixels) + 1)-th largest
    pixel gap, a pixel's gap being its worst channel's
    |level + 0.5 - 255 ref|, which is 0.5 at most where the delivered
    levels are the reference's own, truncated. `spare` 0 gives the worst
    pixel's gap; a NaN anywhere gives NaN."""
    got = levels.permute(2, 0, 1).float() + 0.5
    gap = (got - 255.0 * ref.float()).abs().amax(0).flatten()
    if bool(torch.isnan(gap).any()):
        return math.nan
    return float(torch.topk(gap, int(spare * gap.numel()) + 1).values[-1])


def worst(values) -> float:
    """The largest of `values`, or NaN if any is NaN (Python's max can pass
    over a NaN)."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def percentile(values, q: float) -> float:
    """The q-th percentile (nearest rank) of `values`."""
    s = sorted(values)
    return float(s[min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))])

