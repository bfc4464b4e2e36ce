"""Synthetic scenes, reference functions and a network-viewer client
shared by tests and the chip smoke run.

``random_gaussians`` draws with numpy from a seed and returns numpy arrays,
so a test can hand the very same values to the JAX package and the port.
"""

from __future__ import annotations

import json
import math
import os
import random
import socket
import time

import numpy as np
import torch

from ..core import cameras as camlib
from ..core import sh as shlib
from ..device import resolve_device
from ..models import gaussians as gm
from ..ops import binning, projection


def look_at_camera(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0),
                   fovx=math.radians(60), width=256, height=256,
                   device=None, **kw) -> camlib.Camera:
    """Camera at `eye` looking at `target` (COLMAP-style: +z forward, +y
    down), on `device` (the card unless the caller names the CPU)."""
    eye = np.asarray(eye, dtype=np.float64)
    fwd = np.asarray(target, dtype=np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)
    t = -R.T @ eye
    focal = width / (2.0 * math.tan(fovx / 2.0))
    fovy = 2.0 * math.atan(height / (2.0 * focal))
    return camlib.make_camera(R, t, fovx, fovy, width, height, device=device,
                              **kw)


def random_gaussians(seed: int, n: int, sh_degree: int = 3,
                     extent: float = 1.0, scale_range=(0.02, 0.1),
                     opacity_range=(0.3, 0.95)) -> dict:
    """World-space Gaussians (post-activation values) as f32 numpy arrays:
    means (n, 3), scales (n, 3), quats (n, 4), opacities (n,), sh (n, 3K)
    in the flat channel-minor layout."""
    rng = np.random.default_rng(seed)
    k = shlib.num_sh_bases(sh_degree)
    f32 = np.float32
    means = rng.uniform(-extent, extent, (n, 3)).astype(f32)
    scales = rng.uniform(scale_range[0], scale_range[1], (n, 3)).astype(f32)
    quats = rng.standard_normal((n, 4), dtype=f32)
    opac = rng.uniform(opacity_range[0], opacity_range[1], n).astype(f32)
    sh = 0.3 * rng.standard_normal((n, 3 * k), dtype=f32)
    sh[:, :3] = shlib.rgb_to_sh(rng.uniform(0.05, 0.95, (n, 3)).astype(f32))
    return dict(means=means, scales=scales, quats=quats, opacities=opac,
                sh=sh.astype(f32))


def captured_store(seed: int, n: int, sh_degree: int = 3,
                   active_sh_degree: int | None = None, device=None):
    """A store of `n` rows in the storage spaces, shaped as a captured
    scene, drawn with numpy from `seed`: 85 % of the positions uniform in
    the unit ball, the rest in a shell of radii 3-8; log-normal scales
    (medians 0.005 inside, 0.03 outside, sigma 0.5); quaternions N(0, 1);
    opacity logits N(0, 1.5^2); SH DC N(0, 0.6^2), the higher bands
    N(0, 0.05^2). Every row active; on `device` (the card unless the caller
    names the CPU)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    core = rng.random(n) < 0.85
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    radius = np.where(core, rng.random(n) ** (1 / 3),
                      rng.uniform(3.0, 8.0, n))
    scale = np.log(np.where(core, 0.005, 0.03))[:, None] \
        + 0.5 * rng.standard_normal((n, 3))
    k = shlib.num_sh_bases(sh_degree)
    params = {
        "xyz": d * radius[:, None], "scaling": scale,
        "rotation": rng.standard_normal((n, 4)),
        "opacity": 1.5 * rng.standard_normal((n, 1)),
        "features_dc": 0.6 * rng.standard_normal((n, 3)),
        "features_rest": 0.05 * rng.standard_normal((n, 3 * (k - 1))),
        "exposure": np.eye(3, 4)[None]}
    dev = resolve_device(device)
    t = {name: torch.as_tensor(v.astype(f32), device=dev)
         for name, v in params.items()}
    return gm.GaussianState(
        params=gm.GaussianParams(**t),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        active_sh_degree=(sh_degree if active_sh_degree is None
                          else active_sh_degree),
        max_sh_degree=sh_degree)


def ring_camera(angle: float, width: int, height: int, focal: float,
                radius: float = 2.2, rise: float = 0.4,
                device=None) -> camlib.Camera:
    """A view from a ring of `radius` at height `rise` around the origin,
    at `angle` radians, looking at the origin with a `focal`-pixel lens."""
    eye = (radius * math.cos(angle), -rise, radius * math.sin(angle))
    return look_at_camera(eye, fovx=camlib.focal_to_fov(focal, width),
                          width=width, height=height, device=device)


# The rows of edge_store: the cull's edges and an inactive row.
AT_NEAR, PAST_NEAR, AT_ZERO, BEHIND, FLAT, INACTIVE = range(6)


def axis_camera(wh: int = 64, device=None) -> camlib.Camera:
    """A square view from the origin down +z, 60 degrees wide: camera space
    is world space, and the focal lengths are equal."""
    fov = math.radians(60)
    return camlib.make_camera(np.eye(3), np.zeros(3), fov, fov, wh, wh,
                              device=device)


def edge_store(seed: int, degree: int, n: int = 256, device=None):
    """`n` rows before :func:`axis_camera`, SH bands to 3 (`degree`
    active), every seventh row inactive, and rows 0-5 at the cull's edges:
    camera z exactly 0.2 (culled), the next f32 above it (kept), z = 0
    (culled; inf and NaN in the geometry), z = -1, a Gaussian whose
    dilated 2D covariance has det exactly 0 (culled: a needle along the
    view axis at x = y, its 2D covariance L (1 1; 1 1) with L so large that
    L + 0.3 rounds to L), and an inactive row in view."""
    st = captured_store(seed, n, active_sh_degree=degree, device="cpu")
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 6.0, n)
    xyz = np.stack([rng.uniform(-0.5, 0.5, n) * z,
                    rng.uniform(-0.5, 0.5, n) * z, z], 1).astype(np.float32)
    xyz[AT_NEAR] = (0.0, 0.0, np.float32(0.2))
    xyz[PAST_NEAR] = (0.0, 0.0, np.nextafter(np.float32(0.2), np.float32(1)))
    xyz[AT_ZERO] = (0.1, 0.0, 0.0)
    xyz[BEHIND] = (0.0, 0.0, -1.0)
    xyz[FLAT] = (0.6, 0.6, 2.0)
    p = st.params
    scaling, rotation = p.scaling.clone(), p.rotation.clone()
    scaling[FLAT] = torch.tensor([-60.0, -60.0, 10.0])
    rotation[FLAT] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    active = torch.arange(n) % 7 != 6
    active[INACTIVE] = False
    dev = resolve_device(device)
    params = p.replace(xyz=torch.from_numpy(xyz), scaling=scaling,
                       rotation=rotation)
    return gm.GaussianState(
        params=gm.GaussianParams(**{k: v.to(dev)
                                    for k, v in vars(params).items()}),
        active=active.to(dev), active_sh_degree=degree, max_sh_degree=3)


def bf16_steps(a, b):
    """How many bf16 values apart two bf16-rounded f32 tensors lie: their
    bits on a line where adjacent floats are adjacent integers, over 2^16."""
    def ordered(x):
        u = x.view(torch.int32).to(torch.int64)
        return torch.where(u < 0, -(u & 0x7FFFFFFF), u)
    return (ordered(a) - ordered(b)).abs() / 65536


def projection_gaps(got, want, state, camera) -> dict:
    """K8's projection `got` (``ops/projection.py::project_state``) of
    `state` from `camera` against its plain version's `want`: the rows
    whose cull differs, those both keep at another radius and the largest
    radius gap, those both keep at another depth (K8 fuses the products'
    terms as cuBLAS does, so none: the binning's depth order is the plain
    version's), the largest gap of a rounded output on the rows both keep
    (``max_abs``), and per field the worst gap over its tolerance (1 at the
    tolerance) on the rows both keep (the colour: on every row).

    Tolerances. PyTorch's reductions (the quaternion's and the direction's
    norms, the covariance's and the SH colour's sums) and its
    matrix-vector product (the mean's w) may sum in another order than
    K8's left to right. So the pixel mean is held to 8 f32 ulps of the
    magnitudes its products sum, carried through 1/w and the pixel scale,
    plus 8 ulps of the value; a rounded output to one bf16 step where both
    values round to neighbours. Where a value is small beside the terms it
    is summed from, an error of f32 ulps of the terms is many bf16 steps of
    the value: a conic entry is held to one bf16 step of its row's largest
    entry (the terms' scale), and a colour near the clamp at 0 to 2^-12
    (a thousand f32 ulps of the SH terms, which lie under 4)."""
    ulp = 2.0 ** -24
    kept_g, kept_w = got.radius > 0, want.radius > 0
    both = kept_g & kept_w
    out = {"cull_moved": int((kept_g != kept_w).sum()),
           "radius_moved": int((got.radius != want.radius)[both].sum()),
           "radius_gap": int((got.radius - want.radius).abs().max()),
           "depth_moved": int((got.depth.view(torch.int32)
                               != want.depth.view(torch.int32))[both].sum()),
           "max_abs": max(float((getattr(got, name)[both]
                                 - getattr(want, name)[both]).abs().max())
                          for name in ("conic", "opacity", "rgb",
                                       "invdepth"))}
    x = state.params.xyz[both]
    fp = camera.full_proj
    terms = x.abs() @ fp.abs()[[0, 1, 3], :3].T + fp.abs()[[0, 1, 3], 3]
    w = (x @ fp[3, :3] + fp[3, 3]).abs()[:, None]
    size = torch.tensor([camera.width, camera.height], dtype=torch.float32,
                        device=x.device)
    m = want.mean2d[both]
    ndc = ((2 * m + 1) / size - 1).abs()
    tol = 8 * ulp * (size / 2 * (terms[:, :2] + ndc * terms[:, 2:]) / w
                     + m.abs() + size)
    out["mean2d"] = float(((got.mean2d[both] - m).abs() / tol).max())
    for name in ("opacity", "invdepth"):
        out[name] = float(bf16_steps(getattr(got, name)[both],
                                     getattr(want, name)[both]).max())
    g, w = got.conic[both], want.conic[both]
    step = 2.0 ** -7 * torch.maximum(g.abs(), w.abs()).amax(1, keepdim=True)
    out["conic"] = float(torch.where(
        bf16_steps(g, w) <= 1, 0.0, (g - w).abs() / step).max())
    g, w = got.rgb, want.rgb
    out["rgb"] = float(torch.where(
        bf16_steps(g, w) <= 1, 0.0, (g - w).abs() / 2.0 ** -12).max())
    return out


def enumerate_slots(proj, width: int, height: int) -> np.ndarray:
    """(tile, Gaussian) for every tile of every Gaussian's rect, the
    Gaussians in stable depth order and the tiles row-major: K7's slots
    written out as loops, (total, 2) int64."""
    grid_x, _ = binning.grid_shape(width, height)
    xmin, ymin, xmax, ymax = (t.tolist() for t in projection.tile_rect(
        proj.mean2d, proj.radius, width, height))
    order = np.argsort(proj.depth.cpu().numpy(), kind="stable")
    slots = [(ty * grid_x + tx, int(j)) for j in order
             for ty in range(ymin[j], ymax[j])
             for tx in range(xmin[j], xmax[j])]
    return np.array(slots, dtype=np.int64).reshape(-1, 2)


def wide_gaussians(n: int = 2000) -> dict:
    """The chip smoke's wide scene (phase ``bin``): ``random_gaussians(7,
    n)`` at scales 0.001-0.004 with Gaussian 0 moved to the origin at scale
    0.6 and opacity 0.9. Before a 4096x256 camera at (0, 0, -2.5) its rect
    spans all 256 tile columns, and most of the small ones lie above or
    below the view: zero-count rects in front of the camera, between the
    live ones in depth order."""
    g = random_gaussians(7, n, extent=1.0, scale_range=(0.001, 0.004))
    g["means"][0] = 0.0
    g["scales"][0] = 0.6
    g["opacities"][0] = 0.9
    return g


def _tile_inputs(rng, widths, heights, p_cap: int, grid=(300, 100)) -> dict:
    """K7's inputs for depth-ordered rects of the given sizes (a zero width
    or height is a zero-count rect) at random places on the tile grid."""
    import torch
    grid_x, grid_y = grid
    counts = widths * heights
    incl = np.cumsum(counts)
    x0 = rng.integers(0, grid_x - widths + 1)
    y0 = rng.integers(0, grid_y - heights + 1)
    i32 = torch.int32
    return dict(
        offsets=torch.from_numpy(np.minimum(incl - counts, p_cap)).to(i32),
        base=torch.from_numpy(y0 * grid_x + x0).to(i32),
        nx=torch.from_numpy(widths).to(i32),
        gid=torch.from_numpy(rng.permutation(widths.size)).to(i32),
        total=torch.tensor([min(int(incl[-1]), p_cap)], dtype=i32),
        p_cap=p_cap, grid_x=grid_x, num_tiles=grid_x * grid_y)


def tile_window_cases(grid_y: int = 100) -> dict:
    """K7's inputs (``ops/binning.py::expand_tiles``) built directly on a
    300 x `grid_y` tile grid (at least 34 rows) at the extremes of its owner
    window (``owner_window_plain`` with K7's partition), as CPU tensors:

    * zero_runs: 1-9 x 1-9 rects with runs of zero-count rects between
      them (zero width, or zero height with a width), 0-2 long mostly and
      1-300 long one time in ten, zero-count rects at the tail, padding
      slots;
    * clamped_tail: the capacity, a multiple of the block, below the total
      (the tail's offsets clamped to it);
    * ragged_capacity: a capacity that is a multiple neither of the block
      nor of a thread's four slots, below the total;
    * wide_rect: a rect 300 tiles wide and 30 high (9,000 slots, one owner
      over 9+ blocks) among small ones;
    * dense: 1 x 1 rects each after a zero-count one (blocks of 1,024
      owners over 2,047 entries);
    * empty: no pair at all (total 0);
    * spill: a block whose owners span exactly the window's 2,048 entries,
      one whose owners span one entry more, and later a run of 5,000
      zero-count rects: the last two search in device memory.
    """
    rng = np.random.default_rng(41)
    i64 = np.int64

    def interleaved(n_live, run_hi, p_long=1.0):
        parts = []
        for _ in range(n_live):
            run = int(rng.integers(1, run_hi + 1) if rng.random() < p_long
                      else rng.integers(0, 3))
            w = rng.integers(0, 9, run) * (rng.random(run) < 0.5)
            parts.append(np.stack([w, np.where(w > 0, 0, 3)]))
            parts.append(rng.integers(1, 10, (2, 1)))
        return np.concatenate(parts, axis=1).astype(i64)

    def rects(*blocks):
        wh = np.concatenate(blocks, axis=1).astype(i64)
        return wh[0], wh[1]

    def ones(k):
        return np.ones((2, k), i64)

    def zeros(k):
        return np.zeros((2, k), i64)

    cases = {}
    w, h = rects(interleaved(800, 300, 0.1), zeros(40))
    cases["zero_runs"] = (w, h, int((w * h).sum()) + 1501)
    w, h = rects(interleaved(1500, 6), zeros(10))
    cases["clamped_tail"] = (w, h, 1024 * (int((w * h).sum()) // 1024 - 2))
    cases["ragged_capacity"] = (w, h, (int((w * h).sum()) - 777) // 4 * 4 - 1)
    w, h = rects(interleaved(300, 3), [[300], [30]], interleaved(300, 3))
    cases["wide_rect"] = (w, h, int((w * h).sum()) + 1024)
    w, h = rects(*[np.array([[0, 1], [5, 1]])] * 3000, zeros(3))
    cases["dense"] = (w, h, int((w * h).sum()) + 101)
    cases["empty"] = (np.zeros(500, i64), np.zeros(500, i64), 2048)
    w, h = rects(ones(1), zeros(2046), [[31], [33]], ones(1), zeros(2047),
                 [[31], [33]], interleaved(200, 4), zeros(5000),
                 interleaved(200, 4), zeros(30))
    cases["spill"] = (w, h, int((w * h).sum()) + 4096)
    return {name: _tile_inputs(rng, w, h, p_cap, (300, grid_y))
            for name, (w, h, p_cap) in cases.items()}


def write_depth_priors(scene: str, size: int, n_views: int,
                       tool=None) -> list:
    """Inverse-depth priors for a scene of the port's
    ``make_synthetic_scene`` (`tool`, that module unless the caller hands
    in a copy): each view's camera-space inverse depth from the tool's own
    ``camera_pose`` and ``render_view`` (which
    returns the distance along the unit ray: z = distance / |(x, y, 1)|),
    written as 16-bit PNGs ``<scene>/depths/r_<i>.png`` (value x 65,536,
    clipped; sky 0), which the loader reads with ``depths="depths"``.
    Returns the inverse depths as f32 arrays."""
    from PIL import Image  # noqa: PLC0415
    if tool is None:
        from .. import make_synthetic_scene as tool  # noqa: PLC0415
    focal = 0.82 * size
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)
    ray = np.sqrt(((xs - size / 2.0) / focal) ** 2
                  + ((ys - size / 2.0) / focal) ** 2 + 1.0)
    os.makedirs(os.path.join(scene, "depths"), exist_ok=True)
    out = []
    for i in range(n_views):
        R, t = tool.camera_pose(i, n_views)
        _, dist, _ = tool.render_view(R, t, size, focal)
        inv = np.where(np.isfinite(dist), ray / np.where(
            np.isfinite(dist), dist, 1.0), 0.0)
        png = np.clip(np.round(inv * 65536.0), 0, 65535).astype(np.uint16)
        Image.fromarray(png).save(os.path.join(scene, "depths",
                                               f"r_{i:03d}.png"))
        out.append(inv.astype(np.float32))
    return out


def adam_agreement(got: dict, want: dict, before: dict,
                   lr_k: float) -> tuple:
    """How closely two optimizer runs from the same parameters `before`
    agree, each a {name: array} after k AdamW steps: (share of entries
    whose change differs by at most 1e-3·lr_k, largest difference in
    units of lr_k), lr_k the sum of the k updates' learning rates. Adam's
    first updates are about lr·sign(g), so an entry whose gradient is at
    rounding level in both runs can move by ±lr in one and not the
    other; the depth trainer's checks ask for a share >= 0.999 and a
    largest difference <= 2."""
    diff = np.concatenate([
        np.abs((np.asarray(got[n]) - before[n])
               - (np.asarray(want[n]) - before[n])).ravel()
        for n in before])
    return (float((diff <= 1e-3 * lr_k).mean()),
            float(diff.max() / lr_k))


def free_port_below_ephemeral(host: str = "127.0.0.1") -> int:
    """A free port of `host` below the kernel's ephemeral range, for a
    server that a client dials before the server has bound it. Sockets
    that bind port 0 (gloo's and NCCL's listeners, other tests' servers)
    take ports of the ephemeral range, so none of them can take this one
    between the check and the server's bind, and the client cannot reach
    one of theirs."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except OSError:
        low = 32768
    for port in random.Random().sample(range(10_000, low), 200):
        with socket.socket() as sock:
            try:
                sock.bind((host, port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port below the ephemeral range")


def camera_message(cam: camlib.Camera, train: bool = True,
                   keep_alive: bool = False,
                   scaling_modifier: float = 1.0) -> dict:
    """The request a SIBR remote-viewer client sends for `cam` (the
    inverse of ``viewer/network_gui.py::_decode_camera``), with its
    flags."""
    view = cam.world_view.detach().cpu().numpy().T.copy()
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    proj = cam.full_proj.detach().cpu().numpy().T.copy()
    proj[:, 1] = -proj[:, 1]
    return {"resolution_x": cam.width, "resolution_y": cam.height,
            "train": train, "fov_y": cam.fovy, "fov_x": cam.fovx,
            "z_near": cam.znear, "z_far": cam.zfar, "keep_alive": keep_alive,
            "scaling_modifier": scaling_modifier,
            "view_matrix": view.reshape(-1).tolist(),
            "view_projection_matrix": proj.reshape(-1).tolist()}


class ViewerClient:
    """A client of the network viewer's protocol, as the SIBR app speaks
    it."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def _recv(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError(f"server closed after {len(buf)} of "
                                      f"{n} bytes")
            buf += chunk
        return bytes(buf)

    def request(self, message: dict):
        """Send one request; (the H×W×3 uint8 image or None, the verify
        string). Raises ConnectionError if the server dropped the
        request."""
        payload = json.dumps(message).encode("utf-8")
        self.sock.sendall(len(payload).to_bytes(4, "little") + payload)
        w, h = message["resolution_x"], message["resolution_y"]
        image = None
        if w and h:
            image = np.frombuffer(self._recv(w * h * 3),
                                  np.uint8).reshape(h, w, 3)
        n = int.from_bytes(self._recv(4), "little")
        return image, self._recv(n).decode("ascii")

    def close(self):
        self.sock.close()


def connect_viewer(port: int, deadline: float = 60.0,
                   host: str = "127.0.0.1") -> ViewerClient:
    """A ViewerClient of a server that may not listen yet, dialled every
    50 ms for up to `deadline` s. Pick `port` with
    :func:`free_port_below_ephemeral`, so that what answers is that
    server."""
    t0 = time.monotonic()
    while True:
        try:
            return ViewerClient(host, port)
        except ConnectionRefusedError:
            if time.monotonic() - t0 > deadline:
                raise
            time.sleep(0.05)

