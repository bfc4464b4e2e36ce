"""The multi-rank training step: camera data parallelism x Gaussian
sharding, with an optional tile-band split of the compositor (counterpart
of the JAX package's ``parallel/step.py``).

Per rank, one step (see ``mesh.py`` for the axes):
  1. take the camera of this data rank from the batch;
  2. project this rank's Gaussian shard, with a zero ``screen_offset`` that
     carries the densification gradient;
  3. all-gather the projected attributes over the gauss group (one
     collective; its transpose sums the gradients back to the shard);
  4. bin the gathered set (K1, tile sort, K5a) and composite: the whole
     frame (K2), or with ``tile_shard`` this rank's band of the tile grid
     (K6), the bands all-gathered into the frame;
  5. the loss (L1 + D-SSIM + depth-L1, masked for padded cameras) divided by
     n_gauss, since every gauss rank computes it and the gathers' transposes
     add the n_gauss copies;
  6. the backward: K3 or K6's backward, K5b, K4, the projection;
  7. max of overflow and pair count over data, the exposure gradient summed
     over gauss, every gradient averaged over data; visibility and radii
     maxed over data; Adam and the densification statistics, both dropped
     for the whole grid when any data rank overflowed or lost its loss.

State and Adam moments are this rank's shard (``integrate.place_sharded``);
the step returns new tensors and reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.cameras import Camera
from ..models import densify as densify_ops
from ..models.gaussians import PARAM_NAMES, GaussianParams, GaussianState
from ..ops import binning, losses
from ..ops import projection as proj_ops
from ..ops import rasterize as raster_ops
from ..ops import reference as ref_ops
from ..ops.ssim import ssim_map
from ..train import optim
from ..train.step import _where, depth_l1_weight, learning_rates
from ..utils.config import BACKENDS, OptimizationConfig, PipelineConfig
from .mesh import DATA_AXIS, GAUSS_AXIS, Mesh, all_gather_rows, pmax, psum

# Columns of the gathered projection: mean2d (2), conic (3), opacity, rgb
# (3), depth, inverse depth, and the radius's int32 bits.
_PROJ_COLS = 12


def _gather_projected(proj: proj_ops.ProjectedGaussians,
                      mesh: Mesh) -> proj_ops.ProjectedGaussians:
    """The gauss group's projections in rank order (the rows of the global
    store), in one collective. Values are copied bit for bit."""
    cols = torch.cat([proj.mean2d, proj.conic, proj.opacity[:, None],
                      proj.rgb, proj.depth[:, None], proj.invdepth[:, None],
                      proj.radius.view(torch.float32)[:, None]], 1)
    full = all_gather_rows(cols, mesh, GAUSS_AXIS)
    return proj_ops.ProjectedGaussians(
        mean2d=full[:, 0:2], conic=full[:, 2:5], opacity=full[:, 5],
        rgb=full[:, 6:9], depth=full[:, 9], invdepth=full[:, 10],
        radius=full[:, 11].detach().contiguous().view(torch.int32))


def _rasterize_tile_sharded(proj_full, bg, width: int, height: int,
                            mesh: Mesh, pair_capacity: int | None = None,
                            valid_capacity: int | None = None):
    """Every gauss rank bins the whole gathered set, composites its band of
    the tile grid with K6, and the bands are all-gathered into the frame.
    A band's gradient table is zero outside its own pairs, so the sum that
    the projection gather's transpose takes over the group is the frame's
    gradient."""
    n = proj_full.mean2d.shape[0]
    if pair_capacity is None:
        pair_capacity = raster_ops.default_pair_capacity(n)
    table, aux = binning.bin_sorted_pairs(proj_full, width, height,
                                          pair_capacity, valid_capacity)
    nt = aux["tile_start"].shape[0]
    ids, start, end = raster_ops.band_slots(
        aux["tile_start"], aux["tile_end"], mesh.n_gauss, mesh.gauss_rank)
    color_b, invd_b, t_b = raster_ops.composite_bands(table, ids, start, end,
                                                      width, height)
    # (band, 5, PIX): one gather along the slots, pad slots dropped.
    bands = torch.cat([color_b, invd_b, t_b]).transpose(0, 1)
    full = all_gather_rows(bands, mesh, GAUSS_AXIS)[:nt].transpose(0, 1)
    color = raster_ops.tiles_to_image(full[:3], width, height)
    invd = raster_ops.tiles_to_image(full[3:4], width, height)
    t_fin = raster_ops.tiles_to_image(full[4:5], width, height)
    return {"render": color + t_fin * bg[:, None, None], "invdepth": invd,
            "final_T": t_fin[0],
            "overflow": aux["overflow_rect"] + aux["overflow_valid"],
            "num_pairs": aux["num_valid"]}


def _render_gathered(camera: Camera, state: GaussianState, bg, screen_offset,
                     pipe_cfg: PipelineConfig, mesh: Mesh,
                     tile_shard: bool = False,
                     pair_capacity: int | None = None,
                     valid_capacity: int | None = None):
    """Project the local shard, all-gather it over gauss, rasterize the
    gathered set. Returns (outputs, this shard's radii).

    The backend is the single-rank set (``ops/render.py``): ``kernels``,
    ``oracle`` (the dense reference on purpose) or ``auto`` (kernels on the
    card, the oracle on the CPU); anything else raises."""
    if pipe_cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend {pipe_cfg.backend!r}: use one of "
                         f"{BACKENDS}")
    if camera.tan_wh is not None:
        tanx, tany = camera.tan_wh[0], camera.tan_wh[1]
        map_w, map_h = camera.pix_wh[0], camera.pix_wh[1]
    else:
        tanx, tany = camera.tan_fovx, camera.tan_fovy
        map_w = map_h = None
    proj = proj_ops.project_gaussians(
        state.params.xyz, state.get_covariance(), state.get_opacity(),
        state.get_features(), state.max_sh_degree, camera.world_view,
        camera.full_proj, camera.cam_center, camera.width, camera.height,
        tanx, tany, antialiasing=pipe_cfg.antialiasing,
        valid_mask=state.active, map_width=map_w, map_height=map_h)
    local_radii = proj.radius
    proj = proj.replace(mean2d=proj.mean2d + screen_offset)
    proj_full = _gather_projected(proj, mesh)
    use_kernels = pipe_cfg.backend == "kernels" or (
        pipe_cfg.backend == "auto" and mesh.device.type == "cuda")
    if tile_shard and mesh.n_gauss > 1 and use_kernels:
        out = _rasterize_tile_sharded(proj_full, bg, camera.width,
                                      camera.height, mesh, pair_capacity,
                                      valid_capacity)
    elif use_kernels:
        out = raster_ops.rasterize(proj_full, bg, camera.width, camera.height,
                                   pair_capacity=pair_capacity,
                                   valid_capacity=valid_capacity)
    else:
        out = ref_ops.rasterize_reference(proj_full, bg, camera.width,
                                          camera.height)
    return out, local_radii


def make_sharded_train_step(opt_cfg: OptimizationConfig,
                            pipe_cfg: PipelineConfig, mesh: Mesh,
                            use_trained_exp: bool = False,
                            tile_shard: bool = False,
                            pair_capacity: int | None = None,
                            valid_capacity: int | None = None):
    """Returns step(state, opt_state, cam_batch, step, generator, bg) for
    this rank: `state` and `opt_state` are its shard, `cam_batch` a list of
    one camera per data rank (:func:`stack_cameras`). `generator` is
    unused (the JAX step's key is too) and kept for the single-rank step's
    signature. With `tile_shard` and n_gauss > 1 the gauss ranks also split
    the compositor's tiles into bands (K6). On any data rank's overflow or
    non-finite loss the whole update and the statistics are dropped and
    ``skipped`` is 1."""
    sparse = opt_cfg.optimizer_type == "sparse_adam"
    n_gauss, n_data = mesh.n_gauss, mesh.n_data

    def step(state: GaussianState, opt_state: optim.AdamState, cam_batch,
             step_i: int, generator, bg: torch.Tensor):
        del generator
        camera = cam_batch[mesh.data_rank]
        dev = state.params.xyz.device
        leaves = {k: getattr(state.params, k).detach().requires_grad_(True)
                  for k in PARAM_NAMES}
        screen_offset = torch.zeros(state.capacity, 2, device=dev,
                                    requires_grad=True)
        with torch.enable_grad():
            st = state.replace(params=GaussianParams(**leaves))
            out, radii = _render_gathered(
                camera, st, bg, screen_offset, pipe_cfg, mesh,
                tile_shard=tile_shard, pair_capacity=pair_capacity,
                valid_capacity=valid_capacity)
            image = out["render"]
            if use_trained_exp and camera.exposure_id >= 0:
                exposure = st.get_exposure(
                    camera.exposure_id if camera.exposure_idx is None
                    else camera.exposure_idx)
                image = (torch.einsum("ij,jhw->ihw", exposure[:3, :3], image)
                         + exposure[:3, 3][:, None, None])
            image = torch.clamp(image, 0.0, 1.0)
            gt = camera.image
            if camera.alpha_mask is not None:
                image = image * camera.alpha_mask[None]
            if camera.pix_wh is not None:
                # A padded camera: losses over its true region, normalised
                # by its pixel count (SSIM's convolution is zero-padded, so
                # this is the native-resolution loss).
                mask = camera.alpha_mask[None]
                nval = 3.0 * camera.pix_wh[0] * camera.pix_wh[1]
                ll1 = torch.sum(torch.abs(image - gt) * mask) / nval
                ssim_v = torch.sum(ssim_map(image, gt) * mask) / nval
            else:
                ll1 = losses.l1_loss(image, gt)
                ssim_v = losses.ssim(image, gt)
            loss = ((1.0 - opt_cfg.lambda_dssim) * ll1
                    + opt_cfg.lambda_dssim * (1.0 - ssim_v))
            if opt_cfg.depth_feedback and camera.invdepth is not None:
                mask = (camera.depth_mask if camera.depth_mask is not None
                        else torch.ones_like(camera.invdepth))
                loss = loss + depth_l1_weight(step_i, opt_cfg) * \
                    losses.depth_l1_loss(out["invdepth"][0], camera.invdepth,
                                         mask)
            loss = loss / n_gauss
            inputs = list(leaves.values()) + [screen_offset]
            got = torch.autograd.grad(loss, inputs, allow_unused=True)
        got = [torch.zeros_like(x) if g is None else g
               for x, g in zip(inputs, got)]
        loss, ll1 = loss.detach(), ll1.detach()

        # The exposure table is replicated: each gauss rank holds 1/n_gauss
        # of its gradient. Then every gradient is averaged over data, in
        # one flat buffer.
        got[PARAM_NAMES.index("exposure")] = psum(
            got[PARAM_NAMES.index("exposure")], mesh, GAUSS_AXIS)
        flat = psum(torch.cat([g.reshape(-1) for g in got]), mesh,
                    DATA_AXIS) / n_data
        got = [f.view_as(g) for f, g in
               zip(torch.split(flat, [g.numel() for g in got]), got)]
        grads = GaussianParams(**dict(zip(PARAM_NAMES, got[:-1])))
        screen_grad = got[-1]

        # Max over data of overflow, pair count and "loss not finite"; any
        # data rank overflowing poisons the averaged gradient.
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        flags = pmax(torch.stack([
            zero + (out["overflow"] if "overflow" in out else 0),
            zero + (out["num_pairs"] if "num_pairs" in out else 0),
            (~torch.isfinite(loss)).to(torch.int64)]), mesh, DATA_AXIS)
        overflow, num_pairs = flags[0], flags[1]
        ok = (overflow == 0) & (flags[2] == 0)
        # Radii are >= 0, so max(radii) > 0 is the max over data of
        # (radii > 0).
        max_radii = pmax(radii, mesh, DATA_AXIS)
        visibility = max_radii > 0

        lrs = learning_rates(step_i, opt_cfg, state.spatial_lr_scale)
        new_params, new_opt = optim.adam_update(
            state.params, grads, opt_state, lrs, visibility=visibility,
            sparse=sparse)
        state = state.replace(params=_where(ok, new_params, state.params))
        opt_state = _where(ok, new_opt, opt_state)
        stats = densify_ops.add_densification_stats(
            state, screen_grad, max_radii, camera.width, camera.height)
        state = state.replace(**{k: torch.where(ok, getattr(stats, k),
                                                getattr(state, k))
                                 for k in ("max_radii2d",
                                           "xyz_gradient_accum", "denom")})
        means = psum(torch.stack([loss * n_gauss, ll1]), mesh,
                     DATA_AXIS) / n_data
        metrics = {
            "loss": means[0], "l1": means[1],
            "n_active": psum(state.num_active, mesh, GAUSS_AXIS),
            "num_pairs": num_pairs, "overflow": overflow,
            "skipped": (~ok).to(torch.int32),
        }
        return state, opt_state, metrics

    return step


def stack_cameras(cameras) -> list:
    """One batch of same-size cameras, one per data rank, with their
    per-camera static fields unified as the JAX package's ``stack_cameras``
    does: the exposure index moves into ``exposure_idx``, ``exposure_id``
    becomes 0 if every camera has one (else -1), and the name, uid and depth
    reliability take neutral values."""
    statics = ("height", "width", "fovx", "fovy", "znear", "zfar")
    optional = ("image", "invdepth", "depth_mask", "alpha_mask", "pix_wh",
                "tan_wh")
    first = cameras[0]
    for c in cameras[1:]:
        for f in statics:
            if getattr(c, f) != getattr(first, f):
                raise ValueError(f"stack_cameras: {f} differs; use "
                                 f"pad_camera_batch")
        for f in optional:
            if (getattr(c, f) is None) != (getattr(first, f) is None):
                raise ValueError(f"stack_cameras: {f} is set on some "
                                 f"cameras only")
    all_exp = all(c.exposure_id >= 0 for c in cameras)
    return [dataclasses.replace(
        c, exposure_idx=torch.tensor(max(c.exposure_id, 0), dtype=torch.int32,
                                     device=c.world_view.device),
        exposure_id=0 if all_exp else -1, image_name="", uid=0,
        depth_reliable=False) for c in cameras]


def pad_camera_batch(cameras, target_hw: tuple[int, int] | None = None
                     ) -> list:
    """A batch of cameras of different sizes and intrinsics (the JAX
    package's ``pad_camera_batch``): each is zero-padded onto the (H, W)
    canvas (default: the largest), its true size and tangents move into
    ``pix_wh``/``tan_wh``, fovx and fovy become 0, and its valid region is
    folded into ``alpha_mask``. The step then maps pixels with the true
    intrinsics and masks the losses to the true region."""
    if target_hw is not None:
        H, W = target_hw
    else:
        H = max(c.height for c in cameras)
        W = max(c.width for c in cameras)
    have_depth = all(c.invdepth is not None for c in cameras)
    have_dmask = all(c.depth_mask is not None for c in cameras)

    def pad2(x, h, w):
        if x is None:
            return None
        return torch.nn.functional.pad(x, (0, W - w, 0, H - h))

    out = []
    for c in cameras:
        dev = c.world_view.device
        mask = torch.zeros(H, W, device=dev)
        mask[:c.height, :c.width] = 1.0
        if c.alpha_mask is not None:
            mask = mask * pad2(c.alpha_mask, c.height, c.width)
        out.append(dataclasses.replace(
            c, image=pad2(c.image, c.height, c.width),
            invdepth=pad2(c.invdepth, c.height, c.width)
            if have_depth else None,
            depth_mask=pad2(c.depth_mask, c.height, c.width)
            if have_dmask else None,
            alpha_mask=mask,
            pix_wh=torch.tensor([c.width, c.height], dtype=torch.float32,
                                device=dev),
            tan_wh=torch.tensor([c.tan_fovx, c.tan_fovy], dtype=torch.float32,
                                device=dev),
            height=H, width=W, fovx=0.0, fovy=0.0))
    return stack_cameras(out)
