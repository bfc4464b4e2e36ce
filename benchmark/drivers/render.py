"""``render``: a closed loop of one client over the held-out views through
``train/step.py::eval_image``, the render CLI's and the evaluation's path,
each frame ending with its uint8 image on the host. A sample of the
window's frames, drawn from the seed, is compared with the reference's
images of their views."""

from __future__ import annotations

import math
import random
import time

import torch

from .. import inputs
from ..reference import render as rr
from ..reference import train as rt
from . import Driver, level_gap, to_levels, worst

# The share of a frame's pixels that the comparison passes over. The
# configuration rounds each conic to bfloat16, and where the float32 conic
# of a long, thin Gaussian lies near a rounding midpoint, two sound float32
# projections round it to neighbouring values: the exponent far along the
# Gaussian then moves by units and a few dozen of its pixels by up to ~10
# levels (PERF.md, section 2). A fault of a whole tile (256 pixels) or
# frame still shows.
SPARE = 1e-4


class RenderDriver(Driver):
    """``render``: one client's closed loop over the held-out views."""

    kind = "render"

    def setup(self) -> None:
        p = self.p
        self.cams = [self.camera(i, True) for i in self.test_idx]
        self.state_ = self.state(0)
        self.bg_ = self.bg()
        # The pair capacity, sized once from a probe of every held-out view:
        # at the smallest capacity a frame reports how far its pairs
        # overflow it, which is its pair count less that capacity.
        probe = 4096
        most = 0
        for cam in self.cams:
            out = p["render"].render(cam, self.state_, self.bg_,
                                     backend="kernels", pair_capacity=probe)
            most = max(most, probe + int(out["overflow"]))
        self.capacity = p["rasterize"].round_capacity(
            math.ceil(self.mix["capacity_headroom"] * most))
        self.rng = random.Random(self.seed)
        self.sample = []
        # Warm-up: one frame of every view the loop will render.
        for i in range(len(self.cams)):
            self.frame(i)

    def frame(self, i: int):
        cam = self.cams[i % len(self.cams)]
        res = self.p["step"].eval_image(cam, self.state_, self.bg_,
                                        backend="kernels",
                                        pair_capacity=self.capacity)
        return to_levels(res["render"]).cpu(), res["overflow"]

    def _loop(self, done) -> None:
        k = self.mix["checked_frames"]
        overflow = []
        n = 0
        t0 = time.perf_counter()
        while not done(n, time.perf_counter() - t0):
            t1 = time.perf_counter()
            img, ov = self.frame(n)
            self.latencies.append(time.perf_counter() - t1)
            overflow.append(ov)
            # A uniform sample of the window's frames, drawn from the seed.
            if len(self.sample) < k:
                self.sample.append((n, img))
            else:
                j = self.rng.randrange(n + 1)
                if j < k:
                    self.sample[j] = (n, img)
            n += 1
        self.window_s = time.perf_counter() - t0
        self.units = n
        self.failed = int(sum(int(v) > 0 for v in overflow))

    def window(self, seconds: float) -> None:
        self._loop(lambda n, t: t >= seconds)

    def span(self, tracer) -> None:
        with tracer:
            self._loop(lambda n, t: n >= self.mix["trace_frames"])
        self.span_views = [self.test_idx[i % len(self.cams)]
                           for i in range(self.units)]

    def release(self) -> None:
        del self.cams, self.state_
        self.p = None

    def reference_image(self, index: int,
                        dtype=torch.float32) -> torch.Tensor:
        """The reference's (3, H, W) image of view `index` of the seeded
        store, computed in `dtype`."""
        params = {k: inputs.leaf(self.cfg, self.seed, k, self.device).to(dtype)
                  for k in inputs.LEAVES}
        bg = self.bg(dtype)
        view = self.view(index)
        with rt.true_f32(), torch.no_grad():
            proj = rr.project(params, view, self.cfg["sh_degree"])
            pairs = rr.tile_pairs(proj["attrs"], proj["depth"],
                                  proj["radius"], view["width"],
                                  view["height"])
            return rr.render(proj["attrs"], pairs, view["width"],
                             view["height"], bg)["image"].float()

    def check(self) -> dict:
        """Each sampled frame against the reference's image of its view:
        the gap, in 1/255 levels between the centre of the level the
        program delivered and the reference's value, that all but the worst
        0.01 % of the frame's pixels stay within; the worst frame's."""
        return {"image_gap_p9999": worst(
            level_gap(img.to(self.device), self.reference_image(
                self.test_idx[n % len(self.test_idx)]), SPARE)
            for n, img in self.sample)}

    def controls(self) -> dict:
        """The reference in bfloat16 in the program's place, on the views of
        as many frames as a run samples, judged by the float32 reference."""
        rng = random.Random(self.seed)
        views = rng.sample(self.test_idx, min(self.mix["checked_frames"],
                                              len(self.test_idx)))
        return {"bf16": {"image_gap_p9999": worst(
            level_gap(to_levels(self.reference_image(v, torch.bfloat16)),
                      self.reference_image(v), SPARE) for v in views)}}


DRIVER = RenderDriver
