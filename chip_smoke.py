#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``priordepth_gaussiansplatting_torch/
csrc/`` (one nvcc per source, in parallel), then runs, printing one JSON
line per phase:

  1. device: the card, its power limit, the toolkit and the build;
  2. mid: each kernel against its plain PyTorch version on the same inputs
     (65,536 Gaussians at 512x512, SH degree 3, antialiasing; and a
     dense-overlap scene);
  3. full: 1,000,000 Gaussians at 1600x1066 (bench.py's random Gaussians,
     drawn with numpy) rendered through ops.render.render(backend=
     "kernels") for three views, with the launch counts of that run, each
     kernel against its plain version at full width, and CUDA-event times;
     then "profile": device time by kernel and host time by operator of one
     render per view, from torch.profiler;
  4. cli: the port's render CLI on a raycast synthetic scene;
  5. kernels: one object per kernel (the line before the card's line).
Then the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero, and it does so before printing a result when there is no CUDA
card or when the port is not beside it.

Tolerances: K1 (pair expansion) and K5 (pair table) must equal their plain
versions bit for bit; K1's only allowed difference is a pair whose box
minimum lies within one f32 ulp of the cull limit (logf rounding), at most
0.001% of the rect pairs. K2 (compositor) must be within 2e-5 on >= 99.9% of
values and within 5e-3 everywhere: a product rounded differently can move
the T < 1e-4 stop by one pair (the repo's dense-overlap rule).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor) rate.
CARD_BYTES_PER_S = 3.35e12
CARD_F32_OPS_PER_S = 67e12
# Work per unit, counted from the kernels' sources.
K1_OPS_PER_SLOT = 70      # the cull's f32 operations per pair slot < total
K2_OPS_PER_EVAL = 20      # f32 operations per (pixel, pair), expf as one
KERNELS = {
    "expand_pairs": ("K1", "priordepth_gaussiansplatting_tpu/ops/binning.py:589"),
    "gather_rows": ("K5", "priordepth_gaussiansplatting_tpu/ops/binning.py:1003"),
    "composite_fwd": ("K2",
                      "priordepth_gaussiansplatting_tpu/ops/rasterize_pallas.py:272"),
}
FULL_N, FULL_W, FULL_H = 1_000_000, 1600, 1066
FULL_EYES = [(0.0, 0.0, -2.5), (0.25, -0.15, -2.45), (-0.3, 0.1, -2.4)]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(torch, fn, reps: int = 20, warmup: bool = True) -> float:
    """Mean ms per call of `fn` on the card, by CUDA events."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bits_equal(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


class Smoke:
    def __init__(self):
        import torch

        from priordepth_gaussiansplatting_torch import kernels, interop
        from priordepth_gaussiansplatting_torch.ops import (binning,
                                                            projection,
                                                            rasterize, render)
        from priordepth_gaussiansplatting_torch.utils import testing
        self.torch, self.kernels, self.interop = torch, kernels, interop
        self.binning, self.projection = binning, projection
        self.rasterize, self.render, self.testing = rasterize, render, testing
        self.dev = torch.device("cuda")
        self.results = {}

    # --- inputs ------------------------------------------------------------

    def state(self, g):
        t = self.torch
        params = {
            "xyz": g["means"], "features_dc": g["sh"][:, :3],
            "features_rest": g["sh"][:, 3:], "scaling": np.log(g["scales"]),
            "rotation": g["quats"],
            "opacity": np.log(g["opacities"] / (1 - g["opacities"]))[:, None],
            "exposure": np.eye(3, 4, dtype=np.float32)[None],
        }
        n = g["means"].shape[0]
        state = self.interop.gaussian_state_from_numpy(
            params, np.ones(n, bool), 3, 3, device=self.dev)
        t.cuda.synchronize()
        return state

    def project(self, cam, state):
        return self.projection.project_gaussians(
            state.params.xyz, state.get_covariance(), state.get_opacity(),
            state.get_features(), state.max_sh_degree, cam.world_view,
            cam.full_proj, cam.cam_center, cam.width, cam.height,
            cam.tan_fovx, cam.tan_fovy, antialiasing=True,
            valid_mask=state.active)

    def capacities(self, proj, w, h):
        """bench.py's rule: one probe binning, then the ladder rung above
        1.05x the rect and the kept pair counts."""
        rp = self.rasterize
        total = int(self.binning.depth_sorted_rects(proj, w, h)["total"])
        probe = max(rp.default_pair_capacity(proj.mean2d.shape[0]),
                    rp.round_capacity(total))
        _, aux = self.binning.bin_sorted_pairs(proj, w, h, probe)
        return (rp.round_capacity(int(int(aux["num_rect"]) * 1.05)),
                rp.round_capacity(int(int(aux["num_valid"]) * 1.05)))

    # --- kernel vs plain -----------------------------------------------------

    def check_kernels(self, proj, w, h, p_cap, v_cap, tiles=None):
        """Each kernel against its plain version on the main path's
        intermediates. Returns the per-kernel errors and the inputs."""
        t, b, r = self.torch, self.binning, self.rasterize
        grid_x, grid_y = b.grid_shape(w, h)
        num_tiles = grid_x * grid_y
        rects = b.depth_sorted_rects(proj, w, h)
        k1_args = dict(rects, p_cap=p_cap, grid_x=grid_x, num_tiles=num_tiles)
        got = b.expand_pairs(**k1_args)
        want = b.expand_pairs_plain(**k1_args)
        t.cuda.synchronize()
        tile, gid, attrs, hist = got
        assert bits_equal(t, gid, want[1]), "K1 gaussian ids differ"
        assert bits_equal(t, attrs, want[2]), "K1 attributes differ"
        flips = tile != want[0]
        n_flips = int(flips.sum())
        if n_flips:
            real = t.where(tile == num_tiles, want[0], tile)[flips]
            qmin, limit = b.cull_terms(real, attrs[:, flips], grid_x)
            ulp = t.nextafter(limit, t.full_like(limit, float("inf"))) - limit
            assert bool(((qmin - limit).abs() <= ulp).all()), \
                "K1 culls differ away from the cull limit"
        num_rect = int(rects["total"])
        assert n_flips <= 1e-5 * num_rect, f"K1: {n_flips} cull flips"
        for out, name in ((tile, "kernel"), (want[0], "plain")):
            kept = out[out < num_tiles].long()
            ref_hist = t.bincount(kept, minlength=num_tiles).to(t.int32)
            h_out = hist if name == "kernel" else want[3]
            assert bits_equal(t, h_out, ref_hist), f"K1 {name} histogram"

        ends = t.cumsum(hist, 0).to(t.int32)
        ts = t.clamp_max(ends - hist, v_cap)
        te = t.clamp_max(ends, v_cap)
        perm = t.sort(tile, stable=True).indices
        out_len = v_cap + b.COMPOSITE_PAD
        table, gid_sorted = b.gather_rows(attrs, gid, perm, v_cap, out_len)
        table_p, gid_p = b.gather_rows_plain(attrs, gid, perm, v_cap, out_len)
        t.cuda.synchronize()
        assert bits_equal(t, table, table_p), "K5 table differs"
        assert bits_equal(t, gid_sorted, gid_p), "K5 ids differ"

        sel = None if tiles is None else tiles(ts, te)
        k2 = r.composite_fwd(table, ts, te, grid_x, tiles=sel)
        k2_p = r.composite_fwd_plain(table, ts, te, grid_x, tiles=sel)
        t.cuda.synchronize()
        k2_err = 0.0
        for got_o, want_o, name in zip(k2[:3], k2_p[:3],
                                       ("colour", "invdepth", "final_T")):
            diff = (got_o - want_o).abs()
            close = float((diff <= 2e-5).float().mean())
            k2_err = max(k2_err, float(diff.max()))
            assert close >= 0.999 and float(diff.max()) <= 5e-3, \
                (f"K2 {name}: {close} within 2e-5, max {float(diff.max())}")
        n_eval_same = float((k2[3] == k2_p[3]).float().mean())
        assert n_eval_same >= 0.999, f"K2 pairs evaluated: {n_eval_same}"
        errs = {"expand_pairs": float((attrs - want[2]).abs().max()),
                "gather_rows": float((table - table_p).abs().max()),
                "composite_fwd": k2_err}
        inputs = dict(k1=k1_args, attrs=attrs, gid=gid, perm=perm,
                      v_cap=v_cap, out_len=out_len, table=table, ts=ts,
                      te=te, grid_x=grid_x, tiles=sel)
        return errs, inputs, dict(cull_flips=n_flips, num_rect=num_rect,
                                  num_valid=int(ends[-1]),
                                  k2_tiles=int(k2[0].shape[1]),
                                  k2_n_eval_equal=n_eval_same)

    # --- phases --------------------------------------------------------------

    def phase_device(self, build_seconds, build_wall):
        t = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        from priordepth_gaussiansplatting_torch.kernels import build
        nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[-1]
        ptxas = {}
        for name in KERNELS:
            lines = [ln.split("ptxas info    :")[-1].strip()
                     for ln in build.ptxas_report(name).splitlines()
                     if "Used" in ln or "spill" in ln]
            ptxas[name] = lines
        self.smi = smi
        emit("device", name=t.cuda.get_device_name(0),
             count=t.cuda.device_count(), nvidia_smi=smi, nvcc=nvcc,
             torch=t.__version__, torch_cuda=t.version.cuda,
             build_s={k: round(v, 3) for k, v in build_seconds.items()},
             build_wall_s=round(build_wall, 3), ptxas=ptxas)

    def phase_mid(self):
        T = self.testing
        out = {}
        for label, g, wh, eye in (
                ("n65536_512px", T.random_gaussians(1, 65_536), 512,
                 (0.0, 0.0, -2.5)),
                ("dense_overlap", T.random_gaussians(
                    5, 128, extent=0.3, scale_range=(0.1, 0.3),
                    opacity_range=(0.9, 0.99)), 48, (0.0, 0.0, -2.0))):
            state = self.state(g)
            cam = T.look_at_camera(eye, width=wh, height=wh, device=self.dev)
            proj = self.project(cam, state)
            p_cap, v_cap = self.capacities(proj, wh, wh)
            errs, _, info = self.check_kernels(proj, wh, wh, p_cap, v_cap)
            out[label] = dict(max_abs_err=errs, p_cap=p_cap, v_cap=v_cap,
                              **info)
        emit("mid", ok=True, **out)

    def phase_full(self):
        t, T, k = self.torch, self.testing, self.kernels
        g = T.random_gaussians(0, FULL_N, extent=1.0,
                               scale_range=(0.001, 0.004))
        state = self.state(g)
        cams = [T.look_at_camera(e, width=FULL_W, height=FULL_H,
                                 device=self.dev) for e in FULL_EYES]
        caps = [self.capacities(self.project(c, state), FULL_W, FULL_H)
                for c in cams]
        p_cap = max(c[0] for c in caps)
        v_cap = max(c[1] for c in caps)
        bg = t.zeros(3, device=self.dev)

        def render(cam):
            return self.render.render(cam, state, bg, antialiasing=True,
                                      backend="kernels", pair_capacity=p_cap,
                                      valid_capacity=v_cap)

        # The main path: every count at 0 just before, read just after.
        t.cuda.synchronize()
        k.reset_launch_counts()
        per_view, outs = [], []
        for cam in cams:
            before = k.launch_counts()
            out = render(cam)
            t.cuda.synchronize()
            after = k.launch_counts()
            per_view.append({n: after[n] - before[n] for n in KERNELS})
            outs.append(out)
        launches = k.launch_counts()
        for i, (view, out) in enumerate(zip(per_view, outs)):
            assert all(view[n] >= 1 for n in KERNELS), (i, view)
            img = out["render"]
            assert img.shape == (3, FULL_H, FULL_W)
            assert bool(t.isfinite(img).all()) and bool(
                t.isfinite(out["invdepth"]).all()), f"view {i}: non-finite"
            assert int(out["overflow"]) == 0, f"view {i} overflowed"
            assert float(img.std()) > 0 and int(out["num_pairs"]) > 0
        assert all(launches[n] == len(cams) for n in KERNELS), launches

        # Kernels against plain versions on view 0's intermediates.
        rng = np.random.default_rng(0)

        def sample(ts, te):
            counts = (te - ts).cpu().numpy()
            busiest = np.argsort(-counts, kind="stable")[:32]
            rest = np.setdiff1d(np.arange(counts.size), busiest)
            pick = np.concatenate([busiest, rng.choice(rest, 32, False)])
            return t.as_tensor(pick, dtype=t.int32, device=self.dev)

        proj0 = self.project(cams[0], state)
        errs, x, info = self.check_kernels(proj0, FULL_W, FULL_H, p_cap,
                                           v_cap, tiles=sample)

        # Times on the card (CUDA events), at the main path's shapes.
        b, r = self.binning, self.rasterize
        ms = {
            "expand_pairs": cuda_ms(t, lambda: b.expand_pairs(**x["k1"])),
            "gather_rows": cuda_ms(t, lambda: b.gather_rows(
                x["attrs"], x["gid"], x["perm"], x["v_cap"], x["out_len"])),
            "composite_fwd": cuda_ms(t, lambda: r.composite_fwd(
                x["table"], x["ts"], x["te"], x["grid_x"])),
        }
        plain_ms = {
            "expand_pairs": cuda_ms(t, lambda: b.expand_pairs_plain(**x["k1"]),
                                    reps=3),
            "gather_rows": cuda_ms(t, lambda: b.gather_rows_plain(
                x["attrs"], x["gid"], x["perm"], x["v_cap"], x["out_len"]),
                reps=3),
        }
        full_plain = {}

        def k2_plain():
            full_plain["out"] = r.composite_fwd_plain(x["table"], x["ts"],
                                                      x["te"], x["grid_x"])
        plain_ms["composite_fwd"] = cuda_ms(t, k2_plain, reps=1,
                                            warmup=False)
        head = x["perm"][:x["v_cap"]]

        def library_k5():
            t.nn.functional.pad(x["attrs"].index_select(1, head),
                                (0, x["out_len"] - x["v_cap"]))
            x["gid"].index_select(0, head)
        library_ms = {"expand_pairs": None, "composite_fwd": None,
                      "gather_rows": cuda_ms(t, library_k5)}

        # The whole image of view 0 against the plain compositor.
        k2_full = r.composite_fwd(x["table"], x["ts"], x["te"], x["grid_x"])
        for got_o, want_o in zip(k2_full[:3], full_plain["out"][:3]):
            diff = (got_o - want_o).abs()
            assert float((diff <= 2e-5).float().mean()) >= 0.999
            assert float(diff.max()) <= 5e-3
        n_evals = int(k2_full[3].sum())

        # Least time for each kernel's work on this run's data.
        tot = min(info["num_rect"], p_cap)
        offsets = x["k1"]["offsets"]
        n_live = int((t.diff(offsets, append=x["k1"]["total"]) > 0).sum())
        num_tiles = int(x["ts"].shape[0])
        nv = min(info["num_valid"], v_cap)
        bound = {
            "expand_pairs": ((4 * p_cap + 44 * tot + 4 * num_tiles
                              + 56 * n_live + 4),
                             K1_OPS_PER_SLOT * tot),
            "gather_rows": (8 * x["v_cap"] + 44 * x["v_cap"]
                            + 40 * x["out_len"] + 4 * x["v_cap"], 0),
            "composite_fwd": (40 * nv + 8 * num_tiles
                              + 6 * 4 * num_tiles * 256,
                              K2_OPS_PER_EVAL * n_evals),
        }
        bound_ms, bound_by = {}, {}
        for name, (nbytes, ops) in bound.items():
            tb = nbytes / CARD_BYTES_PER_S * 1e3
            to = ops / CARD_F32_OPS_PER_S * 1e3
            bound_ms[name] = max(tb, to)
            bound_by[name] = "bytes" if tb >= to else "operations"

        # The whole render, end to end, forward only.
        render(cams[0])
        t.cuda.synchronize()
        t.cuda.reset_peak_memory_stats()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            for cam in cams:
                render(cam)
        t.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3 / (reps * len(cams))
        self.results.update(launches=launches, errs=errs, ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        emit("full", ok=True, n=FULL_N, width=FULL_W, height=FULL_H,
             views=len(cams), p_cap=p_cap, v_cap=v_cap,
             launches_per_view=per_view, launches=launches,
             num_pairs=[int(o["num_pairs"]) for o in outs],
             num_rect=info["num_rect"], cull_flips=info["cull_flips"],
             k2_tiles_checked=info["k2_tiles"], max_abs_err=errs,
             n_evals=n_evals, ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
             render_ms_per_frame=frame_ms,
             mray_per_s=FULL_W * FULL_H / frame_ms / 1e3,
             peak_mem_gib=t.cuda.max_memory_allocated() / 2 ** 30)
        self.phase_profile(render, cams)

    def phase_profile(self, render, cams):
        """Where a frame's time goes: device time by kernel name and host
        time by operator, from torch.profiler over one render per view."""
        t = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        render(cams[0])
        t.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for cam in cams:
                render(cam)
            t.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        frames = len(cams)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                acc = by_name.setdefault(e.name, [0.0, 0])
                acc[0] += e.time_range.elapsed_us() / 1e3
                acc[1] += 1
        device_ms = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
        host = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:10]
        emit("profile", frames=frames, traced_wall_ms_per_frame=wall_ms / frames,
             device_ms_per_frame=device_ms / frames,
             device_busy_share=device_ms / wall_ms,
             device_ops_per_frame=sum(v[1] for v in by_name.values()) / frames,
             device_top=[{"name": n[:100], "ms_per_frame": v[0] / frames,
                          "calls_per_frame": v[1] / frames} for n, v in top],
             host_top=[{"name": e.key[:60],
                        "self_ms_per_frame": e.self_cpu_time_total / 1e3 / frames,
                        "calls_per_frame": e.count / frames} for e in host])

    def phase_cli(self):
        from priordepth_gaussiansplatting_torch.train import checkpoint
        from priordepth_gaussiansplatting_torch.utils import config
        env = dict(os.environ, PYTHONPATH=REPO)
        with tempfile.TemporaryDirectory() as tmp:
            scene = os.path.join(tmp, "scene")
            model = os.path.join(tmp, "model")
            subprocess.run([sys.executable, "tools/make_synthetic_scene.py",
                            scene, "256", "4"], cwd=REPO, env=env,
                           check=True, capture_output=True, timeout=600)
            g = self.testing.random_gaussians(3, 20_000, extent=0.8,
                                              scale_range=(0.01, 0.04))
            checkpoint.save_model_snapshot(model, 1000, self.state(g))
            config.save_cfg_args(model, config.ModelConfig(
                source_path=scene, model_path=model))
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m",
                            "priordepth_gaussiansplatting_torch.render",
                            "-m", model], cwd=REPO, env=env, check=True,
                           capture_output=True, timeout=600)
            cli_s = time.perf_counter() - t0
            from PIL import Image
            rdir = os.path.join(model, "train", "ours_1000", "renders")
            pngs = sorted(os.listdir(rdir))
            assert len(pngs) == 4, pngs
            stds = [float(np.asarray(Image.open(os.path.join(rdir, p)),
                                     np.float32).std()) for p in pngs]
            assert min(stds) > 0, stds
        emit("cli", ok=True, renders=len(pngs), png_std=stds,
             cli_seconds=cli_s)

    def kernels_line(self):
        res = self.results
        rows = []
        for name, (kid, replaces) in KERNELS.items():
            rows.append({
                "name": name, "id": kid, "route": "cuda",
                "source": f"priordepth_gaussiansplatting_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": res["launches"][name],
                "max_abs_err": res["errs"][name], "ms": res["ms"][name],
                "plain_ms": res["plain_ms"][name],
                "bound_ms": res["bound_ms"][name],
                "bound_by": res["bound_by"][name],
                "library_ms": res["library_ms"][name],
            })
        print(json.dumps({"kernels": rows}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from priordepth_gaussiansplatting_torch import kernels
    from priordepth_gaussiansplatting_torch.kernels import build
    t0 = time.perf_counter()
    build_seconds = build.build(kernels.KERNELS)
    build_wall = time.perf_counter() - t0
    smoke = Smoke()
    smoke.phase_device(build_seconds, build_wall)
    smoke.phase_mid()
    smoke.phase_full()
    smoke.phase_cli()
    smoke.kernels_line()
    print(smoke.smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
