"""High-level render() (counterpart of the JAX package's ``ops/render.py``).

Takes a Camera and a GaussianState and returns {render, invdepth, radii,
visibility, final_T, overflow, num_pairs}. ``screen_offset`` (an (N, 2)
tensor added to the projected 2D means) is kept for the training path,
where its gradient is the densification statistic. Exposure compensation:
img' = E[:3, :3] img + E[:3, 3] when ``use_trained_exp`` and the camera has
an exposure index (``exposure_idx``, which wins) or id.

Under a profiler the frame is the span ``render`` with its stages
(``utils/tracing.py``): ``render.project`` (activations, covariance,
projection, screen offset), ``render.bin`` (the pair binning and sorts, K1
and K5a; counts ``pairs.rect``, ``pairs.valid``, ``pairs.capacity`` and
``pairs.overflow``), ``render.composite`` (K2) and ``render.assemble``
(tiles to image, background, exposure, clamp).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.cameras import Camera
from ..models.gaussians import GaussianState
from ..utils import tracing
from . import binning
from . import projection as proj_ops
from . import rasterize as raster_ops
from . import reference as ref_ops


def render(
    camera: Camera,
    state: GaussianState,
    bg_color: torch.Tensor,
    *,
    scaling_modifier: float = 1.0,
    antialiasing: bool = False,
    use_trained_exp: bool = False,
    override_color: Optional[torch.Tensor] = None,
    screen_offset: Optional[torch.Tensor] = None,
    backend: str = "auto",
    clamp: bool = True,
    pair_capacity: Optional[int] = None,
    valid_capacity: Optional[int] = None,
):
    """Render one view.

    backend: ``auto`` runs the kernels for tensors on the card and the dense
    oracle on the CPU; ``kernels`` runs the tile pipeline (its plain PyTorch
    versions on the CPU); ``oracle`` the dense oracle."""
    if backend not in ("auto", "kernels", "oracle"):
        raise ValueError(f"unknown backend {backend!r}")
    with tracing.span("render"):
        with tracing.span("render.project"):
            proj = proj_ops.project_gaussians(
                state.params.xyz, state.get_covariance(scaling_modifier),
                state.get_opacity(), state.get_features(),
                state.max_sh_degree, camera.world_view, camera.full_proj,
                camera.cam_center, camera.width, camera.height,
                camera.tan_fovx, camera.tan_fovy, antialiasing=antialiasing,
                valid_mask=state.active, colors_precomp=override_color)
            if screen_offset is not None:
                proj = proj.replace(mean2d=proj.mean2d + screen_offset)

        use_kernels = backend == "kernels" or (
            backend == "auto" and proj.mean2d.device.type == "cuda")
        if use_kernels:
            with tracing.span("render.bin"):
                if pair_capacity is None:
                    pair_capacity = raster_ops.default_pair_capacity(
                        proj.mean2d.shape[0])
                table, aux = binning.bin_sorted_pairs(
                    proj, camera.width, camera.height, pair_capacity,
                    valid_capacity)
                tracing.count("pairs.rect", aux["num_rect"])
                tracing.count("pairs.valid", aux["num_valid"])
                tracing.count("pairs.capacity", pair_capacity)
                tracing.count("pairs.overflow", aux["overflow_rect"])
                tracing.count("pairs.overflow", aux["overflow_valid"])
            with tracing.span("render.composite"):
                tiles = raster_ops.composite_frame(table, aux, camera.width,
                                                   camera.height)
        else:
            out = ref_ops.rasterize_reference(proj, bg_color, camera.width,
                                              camera.height)

        with tracing.span("render.assemble"):
            if use_kernels:
                out = raster_ops.assemble(tiles, aux, bg_color, camera.width,
                                          camera.height)
            image = out["render"]
            if use_trained_exp and (camera.exposure_idx is not None
                                    or camera.exposure_id >= 0):
                exposure = state.get_exposure(
                    camera.exposure_id if camera.exposure_idx is None
                    else camera.exposure_idx)
                image = (torch.einsum("ij,jhw->ihw", exposure[:3, :3], image)
                         + exposure[:3, 3][:, None, None])
            if clamp:
                image = torch.clamp(image, 0.0, 1.0)
    return {
        "render": image,
        "invdepth": out["invdepth"],
        "radii": proj.radius,
        "visibility": proj.radius > 0,
        "final_T": out["final_T"],
        "overflow": out.get("overflow"),
        "num_pairs": out.get("num_pairs"),
    }
