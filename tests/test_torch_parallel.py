"""The multi-rank training step on the CPU: ranks are gloo processes started
by ``parallel/mesh.py::spawn`` (each with its own timeout), held against the
JAX package's ``shard_map`` step on the conftest's 8 CPU devices, on the same
numpy inputs. Tolerances are tests/test_parallel.py's: loss rel 1e-5, xyz
after the step atol 1e-6, xyz_gradient_accum atol 1e-4."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.ops import projection as pproj
from priordepth_gaussiansplatting_torch.ops import rasterize as prast
from priordepth_gaussiansplatting_torch.parallel import integrate as pint
from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
from priordepth_gaussiansplatting_torch.parallel import step as ppar
from priordepth_gaussiansplatting_torch.train import optim as poptim
from priordepth_gaussiansplatting_torch.train import step as pstep
from priordepth_gaussiansplatting_torch.utils import config as pcfg
from priordepth_gaussiansplatting_torch.utils import testing as PT
from priordepth_gaussiansplatting_tpu.models import gaussians as jgm
from priordepth_gaussiansplatting_tpu.parallel import integrate as jint
from priordepth_gaussiansplatting_tpu.parallel import mesh as jmesh
from priordepth_gaussiansplatting_tpu.parallel import step as jpar
from priordepth_gaussiansplatting_tpu.train import optim as joptim
from priordepth_gaussiansplatting_tpu.utils import config as jcfg
from priordepth_gaussiansplatting_tpu.utils import testing as JT

torch.set_num_threads(2)
FIELDS = interop.PARAM_FIELDS
SPAWN_TIMEOUT = 120.0


# --- inputs, as numpy, and both sides' states -------------------------------

def scene(n=32, capacity=64, w=32, h=32, n_cams=1, seed=0, sizes=None):
    """tests/test_parallel.py's scene: JAX's ``create_from_points`` state
    as numpy, and camera specs (eye, width, height, image)."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    state = jgm.create_from_points(pts, cols, num_images=4, capacity=capacity)
    sizes = sizes or [(w, h)] * n_cams
    cams = [dict(eye=(0.2 * i, 0.0, -2.5), width=cw, height=ch,
                 image=rng.rand(3, ch, cw).astype(np.float32))
            for i, (cw, ch) in enumerate(sizes)]
    return jax_state_to_numpy(state), cams


def jax_state_to_numpy(state):
    out = {k: np.array(getattr(state.params, k)) for k in FIELDS}
    out.update(active=np.array(state.active),
               max_radii2d=np.array(state.max_radii2d),
               xyz_gradient_accum=np.array(state.xyz_gradient_accum),
               denom=np.array(state.denom),
               active_sh_degree=int(state.active_sh_degree),
               max_sh_degree=int(state.max_sh_degree),
               spatial_lr_scale=float(state.spatial_lr_scale))
    return out


def jax_state(arrays):
    return jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(arrays[k])
                                     for k in FIELDS}),
        active=jnp.asarray(arrays["active"]),
        max_radii2d=jnp.asarray(arrays["max_radii2d"]),
        xyz_gradient_accum=jnp.asarray(arrays["xyz_gradient_accum"]),
        denom=jnp.asarray(arrays["denom"]),
        active_sh_degree=jnp.asarray(arrays["active_sh_degree"], jnp.int32),
        max_sh_degree=arrays["max_sh_degree"],
        spatial_lr_scale=arrays["spatial_lr_scale"])


def port_state(arrays, device="cpu"):
    return interop.gaussian_state_from_numpy(
        {k: arrays[k] for k in FIELDS}, arrays["active"],
        arrays["active_sh_degree"], arrays["max_sh_degree"], device=device,
        spatial_lr_scale=arrays["spatial_lr_scale"],
        **{k: arrays[k] for k in interop.STAT_FIELDS})


def jax_cams(specs):
    return [dataclasses.replace(
        JT.look_at_camera(s["eye"], width=s["width"], height=s["height"],
                          exposure_id=0), image=jnp.asarray(s["image"]))
        for s in specs]


def port_cams(specs):
    return [PT.look_at_camera(s["eye"], width=s["width"], height=s["height"],
                              exposure_id=0, image=s["image"], device="cpu")
            for s in specs]


def jax_step(arrays, specs, n_data, n_gauss, backend, tile_shard=False,
             pad=False):
    mesh = jmesh.make_mesh(n_data, n_gauss)
    state = jax_state(arrays)
    opt = joptim.init_adam(state.params)
    step = jpar.make_sharded_train_step(
        jcfg.OptimizationConfig(), jcfg.PipelineConfig(backend=backend), mesh,
        tile_shard=tile_shard)
    cams = jax_cams(specs)
    batch = jpar.pad_camera_batch(cams) if pad else jpar.stack_cameras(cams)
    s, o, m = step(state, opt, batch, jnp.asarray(1), jax.random.PRNGKey(0),
                   jnp.zeros(3))
    return jax_state_to_numpy(s), {k: float(v) for k, v in m.items()}


def run(world, job, tmp_path):
    return pmesh.spawn(world, _rank_main, job, backend="gloo",
                       store_dir=str(tmp_path), timeout=SPAWN_TIMEOUT)


# --- what each rank runs (module level, so that spawn can import it) --------

def _rank_main(rank, world, job):
    torch.set_num_threads(1)
    mesh = pmesh.Mesh(job["n_data"], job["n_gauss"], device="cpu")
    return globals()[job["fn"]](mesh, job)


def _sharded(mesh, arrays):
    state = port_state(arrays)
    return pint.place_sharded(state, poptim.init_adam(state.params), mesh)


def _gathered_numpy(state, opt, mesh):
    g_state, g_opt = pint.gather_sharded(state, opt, mesh)
    return (interop.gaussian_state_to_numpy(g_state),
            interop.adam_state_to_numpy(g_opt))


def _job_step(mesh, job):
    """`steps` sharded steps; the global state gathered back, the metrics
    and how often this rank composited a band."""
    state, opt = _sharded(mesh, job["state"])
    cams = port_cams(job["cams"])
    batch = (ppar.pad_camera_batch(cams) if job.get("pad")
             else ppar.stack_cameras(cams))
    fns = pint.make_sharded_fns(
        pcfg.OptimizationConfig(), pcfg.PipelineConfig(backend=job["backend"]),
        mesh, tile_shard=job.get("tile_shard", False))
    calls = []
    bands = prast.composite_bands
    prast.composite_bands = lambda *a: calls.append(1) or bands(*a)
    metrics = []
    for it in range(1, job.get("steps", 1) + 1):
        state, opt, m = fns.step(state, opt, batch, it, None, torch.zeros(3))
        metrics.append({k: float(v) for k, v in m.items()})
    prast.composite_bands = bands
    g_state, g_opt = _gathered_numpy(state, opt, mesh)
    return dict(metrics=metrics, state=g_state, opt=g_opt,
                band_calls=len(calls), shard_rows=state.capacity)


def _job_world_of_one(mesh, job):
    """The sharded step on a world of one and the single-rank step, from
    the same state, camera and step number."""
    cfg = (pcfg.OptimizationConfig(), pcfg.PipelineConfig(backend="kernels"))
    out = {}
    for name in ("sharded", "single"):
        state = port_state(job["state"])
        opt = poptim.init_adam(state.params)
        cam = port_cams(job["cams"])
        if name == "sharded":
            fns = pint.make_sharded_fns(*cfg, mesh)
            state, opt, m = fns.step(state, opt, ppar.stack_cameras(cam), 1,
                                     None, torch.zeros(3))
        else:
            fns = pstep.make_train_step(*cfg)
            state, opt, m = fns.step(state, opt, cam[0], 1, None,
                                     torch.zeros(3))
        out[name] = dict(loss=float(m["loss"]),
                         state=interop.gaussian_state_to_numpy(state),
                         opt=interop.adam_state_to_numpy(opt))
    return out


def _job_densify(mesh, job):
    """Sharded densify with this shard's noise, the single-rank densify of
    the same shard with the same noise, then an opacity reset."""
    state, opt = _sharded(mesh, job["state"])
    noise = torch.from_numpy(job["noise"][mesh.gauss_rank])
    fns = pint.make_sharded_fns(pcfg.OptimizationConfig(),
                                pcfg.PipelineConfig(backend="oracle"), mesh)
    s1, o1, info = fns.densify(state, opt, noise=noise)
    s2, o2, info_local = pstep.make_train_step(
        pcfg.OptimizationConfig(), pcfg.PipelineConfig()).densify(
            state, opt, noise=noise)
    g1 = interop.gaussian_state_to_numpy(s1)
    g2 = interop.gaussian_state_to_numpy(s2)
    same = all(np.array_equal(g1[k], g2[k]) for k in g1)
    same_opt = all(np.array_equal(a, b) for t in ("mu", "nu") for a, b in zip(
        interop.adam_state_to_numpy(o1)[t].values(),
        interop.adam_state_to_numpy(o2)[t].values()))
    s3, o3 = fns.reset_opacity(s1, o1)
    s4, o4, _ = fns.densify(state, opt, seed=3)
    s5, _, _ = fns.densify(state, opt, seed=3)
    g_state, g_opt = _gathered_numpy(s3, o3, mesh)
    return dict(info={k: int(v) for k, v in info.items()},
                info_local={k: int(v) for k, v in info_local.items()},
                same_as_single=same and same_opt, state=g_state, opt=g_opt,
                seeded_repeatable=bool(torch.equal(s4.params.xyz,
                                                   s5.params.xyz)),
                seeded_xyz=s4.params.xyz.numpy())


def _job_grow(mesh, job):
    state, opt = _sharded(mesh, job["state"])
    state, opt, grown = pint.grow_sharded(state, opt, mesh)
    g_state, g_opt = _gathered_numpy(state, opt, mesh)
    return dict(grown=grown, state=g_state, opt=g_opt)


def _job_projection(mesh, job):
    """This rank projects its shard and gathers; it also projects the whole
    store alone. Both as numpy."""
    def project(state, cam):
        return pproj.project_gaussians(
            state.params.xyz, state.get_covariance(), state.get_opacity(),
            state.get_features(), state.max_sh_degree, cam.world_view,
            cam.full_proj, cam.cam_center, cam.width, cam.height,
            cam.tan_fovx, cam.tan_fovy, antialiasing=True,
            valid_mask=state.active)

    cam = port_cams(job["cams"])[0]
    shard, _ = _sharded(mesh, job["state"])
    with torch.no_grad():
        gathered = ppar._gather_projected(project(shard, cam), mesh)
        whole = project(port_state(job["state"]), cam)
    names = ("mean2d", "conic", "opacity", "rgb", "depth", "invdepth",
             "radius")
    return {k: (getattr(gathered, k).numpy(), getattr(whole, k).numpy())
            for k in names}


def _job_fail(mesh, job):
    if mesh.rank == job["bad_rank"]:
        raise ValueError("rank failed on purpose")
    if job.get("sleep"):
        import time
        time.sleep(job["sleep"])
    return mesh.rank


# --- the tests ---------------------------------------------------------------

def check_against_jax(got, want_state, want_loss):
    assert got["metrics"][0]["loss"] == pytest.approx(want_loss, rel=1e-5)
    np.testing.assert_allclose(got["state"]["xyz"], want_state["xyz"],
                               atol=1e-6)
    np.testing.assert_allclose(got["state"]["xyz_gradient_accum"],
                               want_state["xyz_gradient_accum"], atol=1e-4)
    assert float(np.abs(got["state"]["xyz_gradient_accum"]).max()) > 0


@pytest.mark.parametrize("n_data,n_gauss", [(2, 1), (2, 2)])
def test_sharded_step_matches_jax(n_data, n_gauss, tmp_path):
    arrays, specs = scene(n_cams=n_data)
    want_state, want_m = jax_step(arrays, specs, n_data, n_gauss, "oracle")
    results = run(n_data * n_gauss, dict(
        fn="_job_step", n_data=n_data, n_gauss=n_gauss, state=arrays,
        cams=specs, backend="oracle"), tmp_path)
    for got in results:  # every rank gathers the same global state
        check_against_jax(got, want_state, want_m["loss"])
        m = got["metrics"][0]
        assert m["skipped"] == 0 and m["n_active"] == 32 == want_m["n_active"]
        assert got["opt"]["count"] == 1
        assert got["shard_rows"] == 64 // n_gauss
        for k in FIELDS:
            np.testing.assert_array_equal(got["state"][k],
                                          results[0]["state"][k])


def test_tile_sharded_step_matches_jax_and_one_rank(tmp_path):
    """(1, 4) with tile_shard: each rank composites a band of the 3 x 3
    tiles (3 slots, the last band with two pads) through K6's plain
    version, against JAX's pallas step in interpret mode and against the
    port's own (1, 1) step."""
    arrays, specs = scene(w=48, h=48)
    want_state, want_m = jax_step(arrays, specs, 1, 4, "pallas",
                                  tile_shard=True)
    job = dict(fn="_job_step", n_data=1, n_gauss=4, state=arrays, cams=specs,
               backend="kernels", tile_shard=True)
    results = run(4, job, tmp_path)
    (one,) = run(1, dict(job, n_gauss=1), tmp_path)
    assert one["band_calls"] == 0
    for got in results:
        assert got["band_calls"] == 1
        assert got["metrics"][0]["num_pairs"] == want_m["num_pairs"] > 0
        check_against_jax(got, want_state, want_m["loss"])
        check_against_jax(got, one["state"], one["metrics"][0]["loss"])


def test_world_of_one_matches_the_single_rank_step(tmp_path):
    arrays, specs = scene()
    (got,) = run(1, dict(fn="_job_world_of_one", n_data=1, n_gauss=1,
                         state=arrays, cams=specs), tmp_path)
    a, b = got["sharded"], got["single"]
    assert a["loss"] == b["loss"]
    for k in ("xyz", "opacity", "xyz_gradient_accum", "denom",
              "max_radii2d"):
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)
    for k in FIELDS:
        np.testing.assert_array_equal(a["opt"]["mu"][k], b["opt"]["mu"][k])


def test_mixed_resolution_dp_matches_native_losses(tmp_path):
    """pad_camera_batch: a (48 x 32) and a (32 x 48) camera in one (2, 1)
    batch; the batch loss is the mean of each camera's native loss from the
    single-rank step (tests/test_parallel.py's check), and JAX's."""
    arrays, specs = scene(n=24, capacity=32, seed=3,
                          sizes=[(48, 32), (32, 48)])
    native = []
    fns = pstep.make_train_step(pcfg.OptimizationConfig(),
                                pcfg.PipelineConfig(backend="oracle"))
    for cam in port_cams(specs):
        state = port_state(arrays)
        _, _, m = fns.step(state, poptim.init_adam(state.params), cam, 1,
                           None, torch.zeros(3))
        native.append(float(m["loss"]))
    _, want_m = jax_step(arrays, specs, 2, 1, "oracle", pad=True)
    results = run(2, dict(fn="_job_step", n_data=2, n_gauss=1, state=arrays,
                          cams=specs, backend="oracle", pad=True), tmp_path)
    for got in results:
        loss = got["metrics"][0]["loss"]
        assert loss == pytest.approx(np.mean(native), rel=2e-5)
        assert loss == pytest.approx(want_m["loss"], rel=1e-5)
        assert got["metrics"][0]["skipped"] == 0


def densify_inputs(n_gauss, c=64, n_live=48):
    """A state with densification statistics drawn from numpy (so that
    clone, split and prune all fire) and each shard's split noise."""
    rng = np.random.default_rng(5)
    arrays, _ = scene(n=n_live, capacity=c)
    arrays["scaling"][:n_live:3] += 2.0  # large: split, not clone
    arrays["scaling"][2:n_live:3] = np.log(0.005)  # small: clone
    arrays["opacity"][1:n_live:7] = -7.0  # prune
    arrays["xyz_gradient_accum"] = rng.uniform(0, 1e-3, c).astype(np.float32)
    arrays["denom"] = rng.integers(0, 3, c).astype(np.float32)
    noise = rng.standard_normal((n_gauss, 2, c // n_gauss, 3)).astype(
        np.float32)
    return arrays, noise


def test_sharded_densify_and_reset(tmp_path):
    """Counts as JAX's sharded densify gives them (its noise differs, the
    counts do not depend on it); each shard as the single-rank densify of
    that shard with the same noise; then the opacity reset as JAX's."""
    n_gauss = 2
    arrays, noise = densify_inputs(n_gauss)
    mesh_j = jmesh.make_mesh(1, n_gauss)
    state_j = jax_state(arrays)
    st, op = jint.place_sharded(state_j, joptim.init_adam(state_j.params),
                                mesh_j)
    fns_j = jint.make_sharded_fns(jcfg.OptimizationConfig(),
                                  jcfg.PipelineConfig(backend="oracle"),
                                  mesh_j)
    st, op, info_j = fns_j.densify(st, op, jax.random.PRNGKey(0))
    st, op = fns_j.reset_opacity(st, op)
    want = jax_state_to_numpy(st)

    results = run(n_gauss, dict(fn="_job_densify", n_data=1, n_gauss=n_gauss,
                                state=arrays, noise=noise), tmp_path)
    totals = {k: sum(r["info_local"][k] for r in results) for k in
              results[0]["info_local"]}
    for got in results:
        assert got["info"] == {k: int(v) for k, v in info_j.items()}
        assert got["info"] == totals
        assert got["same_as_single"]
        assert got["seeded_repeatable"]
        np.testing.assert_array_equal(got["state"]["active"], want["active"])
        for k in ("opacity", "scaling", "features_dc"):
            # split children's log(scale / 1.6): the two logs may differ
            # by an ulp
            np.testing.assert_allclose(got["state"][k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        assert float(np.max(got["state"]["opacity"][got["state"]["active"]])
                     ) <= float(np.log(0.01 / 0.99)) + 1e-6
    assert min(info_j[k] for k in ("n_cloned", "n_split", "n_pruned")) > 0
    # the seed is folded with the gauss rank: the shards' draws differ
    assert not np.array_equal(results[0]["seeded_xyz"],
                              results[1]["seeded_xyz"])


def test_grow_sharded_matches_jax(tmp_path):
    arrays, _ = scene(n=60, capacity=64)
    mesh_j = jmesh.make_mesh(1, 2)
    state_j = jax_state(arrays)
    st, op = jint.place_sharded(state_j, joptim.init_adam(state_j.params),
                                mesh_j)
    # interop.shard_numpy cuts the rows JAX places on gauss device k
    for k, shard in enumerate(st.params.xyz.addressable_shards):
        assert shard.device == mesh_j.devices[0, k]
        np.testing.assert_array_equal(
            np.asarray(shard.data), interop.shard_numpy(arrays, 2, k)["xyz"])
    st, op, grown_j = jint.grow_sharded(st, op, mesh_j)
    assert grown_j
    want = jax_state_to_numpy(st)
    for got in run(2, dict(fn="_job_grow", n_data=1, n_gauss=2, state=arrays),
                   tmp_path):
        assert got["grown"]
        for k in FIELDS + ("active",) + interop.STAT_FIELDS:
            np.testing.assert_array_equal(got["state"][k], want[k], err_msg=k)
        assert got["opt"]["mu"]["xyz"].shape == (128, 3)


@pytest.mark.parametrize("helper", ["interleave", "compact", "pad"])
def test_row_helpers_match_jax(helper):
    arrays, _ = scene(n=20, capacity=30 if helper == "pad" else 32)
    rng = np.random.default_rng(2)
    arrays["active"] = rng.random(arrays["active"].shape) < 0.6
    for k in interop.STAT_FIELDS:
        arrays[k] = rng.random(arrays[k].shape).astype(np.float32)
    mu = {k: rng.standard_normal(arrays[k].shape).astype(np.float32)
          for k in FIELDS}
    state_j = jax_state(arrays)
    opt_j = joptim.AdamState(
        mu=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
        nu=jgm.GaussianParams(**{k: jnp.asarray(v) ** 2
                                 for k, v in mu.items()}),
        count=jnp.asarray(3, jnp.int32))
    state = port_state(arrays)
    opt = interop.adam_state_from_numpy(mu, {k: v ** 2 for k, v in mu.items()},
                                        3, device="cpu")
    if helper == "interleave":
        sj, oj = jint.interleave_rows(state_j, opt_j, 4)
        s, o = pint.interleave_rows(state, opt, 4)
    elif helper == "compact":
        sj, oj = jint.compact_rows(state_j, opt_j)
        s, o = pint.compact_rows(state, opt)
    else:
        sj, oj = jint.pad_capacity_to_multiple(state_j, opt_j, 4)
        s, o = pint.pad_capacity_to_multiple(state, opt, 4)
        assert s.capacity == 32
    got, want = interop.gaussian_state_to_numpy(s), jax_state_to_numpy(sj)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got_o = interop.adam_state_to_numpy(o)
    for t in ("mu", "nu"):
        for k in FIELDS:
            np.testing.assert_array_equal(got_o[t][k],
                                          np.asarray(getattr(getattr(oj, t),
                                                             k)))
    # shards of the global numpy state and back
    shards = [interop.shard_numpy(got, 4, g) for g in range(4)]
    assert shards[1]["xyz"].shape[0] == s.capacity // 4
    back = interop.unshard_numpy(shards)
    for k in got:
        np.testing.assert_array_equal(back[k], got[k])


def test_gathered_projection_is_bit_equal(tmp_path):
    """Each rank rounds its own shard's attributes to bf16; the gathered
    set equals a one-rank projection of the whole store bit for bit."""
    arrays, specs = scene(n=40, capacity=64)
    for got in run(4, dict(fn="_job_projection", n_data=1, n_gauss=4,
                           state=arrays, cams=specs), tmp_path):
        for k, (a, b) in got.items():
            assert a.shape == b.shape and a.dtype == b.dtype, k
            assert np.array_equal(a.view(np.uint32) if a.dtype == np.float32
                                  else a, b.view(np.uint32)
                                  if b.dtype == np.float32 else b), k


def test_camera_batch_from_numpy_matches_pad_camera_batch():
    _, specs = scene(n=8, capacity=8, sizes=[(48, 32), (32, 48)])
    want = ppar.pad_camera_batch(port_cams(specs))
    batch = jpar.pad_camera_batch(jax_cams(specs))
    got = interop.camera_batch_from_numpy(
        width=batch.width, height=batch.height, fovx=batch.fovx,
        fovy=batch.fovy, exposure_id=batch.exposure_id, device="cpu",
        **{f: (None if getattr(batch, f) is None
               else np.asarray(getattr(batch, f)))
           for f in ("world_view", "full_proj", "cam_center", "image",
                     "invdepth", "depth_mask", "alpha_mask", "pix_wh",
                     "tan_wh", "exposure_idx")})
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b), f.name
            else:
                assert a == b, f.name


def test_spawn_reports_failures_and_timeouts(tmp_path):
    job = dict(fn="_job_fail", n_data=1, n_gauss=2, bad_rank=1)
    with pytest.raises(RuntimeError, match="rank failed on purpose"):
        run(2, job, tmp_path)
    with pytest.raises(TimeoutError):
        pmesh.spawn(2, _rank_main, dict(job, bad_rank=-1, sleep=60),
                    backend="gloo", store_dir=str(tmp_path), timeout=8)
    assert run(2, dict(job, bad_rank=-1), tmp_path) == [0, 1]


def test_backend_follows_the_device(monkeypatch):
    assert pmesh.backend_for("cpu") == "gloo"
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        pmesh.backend_for("cuda")
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    assert pmesh.backend_for("cuda") == "nccl"


def test_initialize_multihost_single_process_is_a_noop(monkeypatch):
    called = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: called.append(kw))
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.initialize_multihost() is False
    assert pmesh.initialize_multihost("tcp://localhost:1234", 2, 1,
                                      device="cpu") is True
    assert called[0]["backend"] == "gloo"
    assert called[0]["init_method"] == "tcp://localhost:1234"
    assert (called[0]["world_size"], called[0]["rank"]) == (2, 1)


def test_densify_noise_is_folded_per_rank():
    assert [pint.fold_in(7, types.SimpleNamespace(n_gauss=4, gauss_rank=g))
            for g in range(4)] == [28, 29, 30, 31]

