"""``train``: the trainer's own loop (``train/trainer.py::Trainer.train``)
on the seeded store, from ``start_iteration``, ``chunk`` iterations a call
(the trainer drains its metrics, a synchronise, at the end of each call).
The first ``checked_steps`` steps of that loop are compared with the
reference's."""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import torch

from .. import inputs
from ..reference import train as rt
from . import Driver, worst


class Scene:
    """The trainer's view of a scene: cameras, extent, exposure ids and the
    point cloud it is constructed on."""

    def __init__(self, train_cameras, test_cameras, extent, cloud):
        self.train_cameras = train_cameras
        self.test_cameras = test_cameras
        self.cameras_extent = extent
        self.exposure_ids = {c.image_name: i
                             for i, c in enumerate(train_cameras)}
        self._cloud = cloud

    def point_cloud(self):
        return self._cloud[0], self._cloud[1], None


class TrainDriver(Driver):
    """``train``: the trainer's loop in the second half of a job."""

    kind = "train"

    def setup(self) -> None:
        cfg, mix, p = self.cfg, self.mix, self.p
        conf = p["config"]
        cams = [self.camera(i, True) for i in self.train_idx]
        scene = Scene(cams, [], self.extent, inputs.small_cloud(self.seed))
        self.opt = conf.OptimizationConfig(
            depth_feedback=cfg["depth_feedback"], **cfg["optimization"])
        self.trainer = p["trainer"].Trainer(
            conf.ModelConfig(sh_degree=cfg["sh_degree"],
                             white_background=cfg["white_background"]),
            self.opt,
            conf.PipelineConfig(antialiasing=cfg["antialiasing"],
                                backend="kernels"),
            scene, seed=self.seed, quiet=True, device=self.device)
        tr = self.trainer
        self.picked = []
        pick = tr.pick_camera

        def recorded():
            cam = pick()
            self.picked.append(cam.uid)
            return cam

        tr.pick_camera = recorded
        # Warm-up: the same loop from `warmup_from`, until the pair-capacity
        # ladder has adapted (it does so on every 100th iteration); then the
        # seeded store again.
        self._seed_store(mix["warmup_from"])
        self._train(mix["start_iteration"])
        self._seed_store(mix["start_iteration"])
        tr._camera_stack = []
        tr.consecutive_skips = 0
        self._checked_steps()

    def _seed_store(self, iteration: int) -> None:
        tr, optim = self.trainer, self.p["optim"]
        tr.state = self.state(len(tr.scene.train_cameras))
        params = tr.state.params

        def moments(which):
            return self.p["gaussians"].GaussianParams(**{
                k: (inputs.moment(self.cfg, self.seed, which, k,
                                  getattr(params, k))
                    if k in inputs.LEAVES
                    else torch.zeros_like(getattr(params, k)))
                for k in self.p["gaussians"].PARAM_NAMES})

        tr.opt_state = optim.AdamState(
            mu=moments("mu"), nu=moments("nu"),
            count=torch.tensor(self.mix["start_iteration"], dtype=torch.int32,
                               device=self.device))
        tr.iteration = iteration

    def _train(self, until: int) -> None:
        self.trainer.train(iterations=until, test_iterations=(),
                           save_iterations=())

    def _checked_steps(self) -> None:
        """The first `checked_steps` steps of the window's own loop from the
        seeded store: their losses, the first gradient as Adam received it,
        the change of each group and the densification statistics."""
        tr = self.trainer
        fns = tr.fns
        losses = []

        def step(*args):
            out = fns.step(*args)
            losses.append(out[2]["loss"])
            return out

        tr.fns = dataclasses.replace(fns, step=step)
        start = tr.iteration
        self.picked = []
        self._train(start + 1)
        got = {"grad": {}, "change": {}}
        for k in inputs.LEAVES:
            mu = getattr(tr.opt_state.mu, k)
            mu0 = inputs.moment(self.cfg, self.seed, "mu", k, mu)
            got["grad"][k] = float(torch.linalg.vector_norm(
                (mu - rt.B1 * mu0) / (1.0 - rt.B1)))
            del mu0
        self._train(start + self.mix["checked_steps"])
        for k in inputs.LEAVES:
            p1 = getattr(tr.state.params, k)
            got["change"][k] = float(torch.linalg.vector_norm(
                p1 - inputs.leaf(self.cfg, self.seed, k, self.device)))
        got["accum"] = float(torch.linalg.vector_norm(
            tr.state.xyz_gradient_accum))
        got["denom"] = float(torch.linalg.vector_norm(tr.state.denom))
        got["loss"] = [float(v) for v in losses]
        got["views"] = list(self.picked)
        got["iterations"] = list(range(start + 1, tr.iteration + 1))
        tr.fns = fns if tr.fns.step is step else tr.fns
        self.program = got

    def window(self, seconds: float) -> None:
        tr = self.trainer
        skips, it0 = tr.total_skips, tr.iteration
        t0 = time.perf_counter()
        while True:
            self._train(tr.iteration + self.mix["chunk"])
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.units = tr.iteration - it0
        self.failed = tr.total_skips - skips

    def span(self, tracer) -> None:
        """The traced span: `trace_chunks` calls of the loop, with the
        store at its start and the views of its steps kept for the
        counts."""
        tr = self.trainer
        self.span_params = {k: getattr(tr.state.params, k).detach().cpu()
                            for k in inputs.LEAVES}
        skips, it0 = tr.total_skips, tr.iteration
        self.picked = []
        with tracer:
            for _ in range(self.mix["trace_chunks"]):
                self._train(tr.iteration + self.mix["chunk"])
        self.units = tr.iteration - it0
        self.failed = tr.total_skips - skips
        self.span_views = list(self.picked)

    def release(self) -> None:
        del self.trainer
        self.p = None

    def span_store(self) -> dict:
        return {k: v.to(self.device) for k, v in self.span_params.items()}

    def check(self) -> dict:
        """The checked steps against the reference's, made again from the
        seed."""
        return compare(self.program, reference_steps(self))

    def controls(self) -> dict:
        """The reference in bfloat16 in the program's place, and the loss
        taken over half of the image (the mean over the rest), each judged
        by the float32 reference."""
        ref = reference_steps(self)
        return {"bf16": compare(reference_steps(self, dtype=torch.bfloat16),
                                ref),
                "half_batch": compare(reference_steps(self, half=True), ref)}


def reference_steps(drv: TrainDriver, half=False,
                    dtype=torch.float32) -> dict:
    """Run the reference over the program's checked steps: the same views,
    iterations and seeded store."""
    cfg, seed, dev = drv.cfg, drv.seed, drv.device
    prog = drv.program
    params = {k: inputs.leaf(cfg, seed, k, dev).to(dtype)
              for k in inputs.LEAVES}
    p0 = {k: v.clone() for k, v in params.items()}
    mu = {k: inputs.moment(cfg, seed, "mu", k, params[k].float()).to(dtype)
          for k in inputs.LEAVES}
    nu = {k: inputs.moment(cfg, seed, "nu", k, params[k].float()).to(dtype)
          for k in inputs.LEAVES}
    opt = cfg["optimization"]
    count = drv.mix["start_iteration"]
    bg = drv.bg(dtype)
    accum = torch.zeros(params["xyz"].shape[0], device=dev)
    denom = torch.zeros_like(accum)
    losses, grads1 = [], None
    with rt.true_f32():
        for v, it in zip(prog["views"], prog["iterations"]):
            target = inputs.target(cfg, seed, v, dev).to(dtype)
            pri = inputs.prior(cfg, seed, v, dev)
            pri = pri.to(dtype) if pri is not None and cfg[
                "depth_feedback"] else None
            loss, grads, params, mu, nu, stat, vis = rt.step(
                params, mu, nu, count, drv.view(v), target, pri, bg, it, opt,
                drv.extent, cfg["sh_degree"], half=half)
            count += 1
            losses.append(float(loss))
            if grads1 is None:
                grads1 = {k: float(torch.linalg.vector_norm(g.float()))
                          for k, g in grads.items()}
            accum += stat.float()
            denom += vis.float()
    return {"loss": losses, "grad": grads1,
            "change": {k: float(torch.linalg.vector_norm(
                (params[k] - p0[k]).float())) for k in inputs.LEAVES},
            "accum": float(torch.linalg.vector_norm(accum)),
            "denom": float(torch.linalg.vector_norm(denom))}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared, from the program's and the reference's
    readings of the checked steps."""
    loss = worst(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = math.inf
    gref = ref["grad"]
    med_g = statistics.median(gref.values())
    grad = worst(abs(prog["grad"][k] - gref[k]) / max(gref[k], med_g)
                 for k in gref)
    # Groups whose gradient is nought to rounding in the reference move by
    # round-off alone under Adam: they are left out of the change.
    moved = [k for k in gref if gref[k] >= 1e-3 * med_g]
    cref = ref["change"]
    change = math.nan
    if moved:
        med_c = statistics.median(cref[k] for k in moved)
        change = worst(abs(prog["change"][k] - cref[k]) / max(cref[k], med_c)
                       for k in moved)
    stats = worst(abs(prog[k] - ref[k]) / ref[k] for k in ("accum", "denom"))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "stats_gap": stats}


DRIVER = TrainDriver
