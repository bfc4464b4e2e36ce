"""SIBR remote-viewer socket protocol, byte-compatible server (counterpart
of the JAX package's ``viewer/network_gui.py``; reference
``gaussian_renderer/network_gui.py:26-86`` and ``train.py:103-119``), so the
prebuilt SIBR_remoteGaussian_app connects unchanged.

The wire: a non-blocking TCP listener; a request is 4-byte little-endian
length-prefixed JSON carrying a camera (row-vector matrices, with columns
1 and 2 of the view and column 1 of the projection sign-flipped) and the
flags ``train``, ``keep_alive`` and ``scaling_modifier``; the reply is the
H×W×3 uint8 RGB image (none when the resolution is 0) followed by a
length-prefixed verify string, the training source path.

Each view renders through ``ops/render.py::render`` at the store's default
pair capacity, so on the card through K1, K5a and K2; a view that
overflows that capacity is counted. On a grid of ranks (``follow`` and
``broadcast_code``) rank 0 serves the socket and tells the other ranks,
by one broadcast int, when to join a render's gather of the store.
"""

from __future__ import annotations

import json
import select
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..core.cameras import Camera
from ..device import launch_counts, resolve_device
from ..ops.render import render as render_fn

# What rank 0 of a grid broadcasts: go on training, join a render's
# gather, or wait on (the GUI holds training).
IDLE, RENDER, PAUSE = 0, 1, 2
# While the GUI holds training on a grid, rank 0 broadcasts PAUSE this
# often, so that the other ranks' waits do not reach the process group's
# timeout.
PAUSE_BEAT_S = 5.0


def _decode_camera(message, device=None) -> Camera | None:
    """The Camera of a request, on `device` (the card unless the caller
    names the CPU), or None when its resolution is 0."""
    width = message["resolution_x"]
    height = message["resolution_y"]
    if width == 0 or height == 0:
        return None
    device = resolve_device(device)
    view = np.array(message["view_matrix"], np.float32).reshape(4, 4)
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    proj = np.array(message["view_projection_matrix"],
                    np.float32).reshape(4, 4)
    proj[:, 1] = -proj[:, 1]
    # The wire format is the row-vector convention; ours is column-vector.
    w2c = view.T
    full = proj.T
    cam_center = np.linalg.inv(w2c)[:3, 3]

    def t(x):
        return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32,
                            device=device)
    return Camera(
        world_view=t(w2c), full_proj=t(full), cam_center=t(cam_center),
        height=int(height), width=int(width),
        fovx=float(message["fov_x"]), fovy=float(message["fov_y"]),
        znear=float(message["z_near"]), zfar=float(message["z_far"]))


class NetworkGUI:
    """Non-blocking remote-render server polled from the train loop, on
    `port` of `host` (0: a free port, then read ``.port``). Renders run on
    `device` (the card unless the caller names the CPU). ``stats`` counts
    the views rendered, those that overflowed their pair capacity, the
    kernel launches of the renders, the requests that failed and the
    connections the GUI closed."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 device=None):
        self.device = resolve_device(device)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                                     1)
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.listener.close()
            raise
        self.listener.settimeout(0)
        self.port = self.listener.getsockname()[1]
        self.conn = None
        self.stats = {"renders": 0, "overflowed_views": 0, "launches": {},
                      "errors": 0, "disconnects": 0}

    def _try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nGUI connected by {addr}", flush=True)
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _read(self):
        head = self.conn.recv(4)
        if not head:
            raise ConnectionError("GUI closed")
        length = int.from_bytes(head, "little")
        payload = b""
        while len(payload) < length:
            chunk = self.conn.recv(length - len(payload))
            if not chunk:
                raise ConnectionError("GUI closed")
            payload += chunk
        return json.loads(payload.decode("utf-8"))

    def _send(self, image_bytes, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def _wait(self, signal) -> None:
        """Wait for the GUI's next request, sending PAUSE every
        PAUSE_BEAT_S meanwhile."""
        while not select.select([self.conn], [], [], PAUSE_BEAT_S)[0]:
            signal(PAUSE)

    def _render(self, cam, state, bg, scaling_modifier: float):
        if callable(state):
            state = state()
        before = launch_counts()
        out = render_fn(cam, state, bg, scaling_modifier=scaling_modifier)
        img = (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8)
        img = img.permute(1, 2, 0).contiguous().cpu().numpy()
        st = self.stats
        st["renders"] += 1
        for k, v in launch_counts().items():
            if v != before[k]:
                st["launches"][k] = st["launches"].get(k, 0) + v - before[k]
        if out["overflow"] is not None and int(out["overflow"]) > 0:
            if not st["overflowed_views"]:
                print(f"WARNING: a viewer frame overflowed the pair "
                      f"capacity by {int(out['overflow'])} — it is missing "
                      "splats", flush=True)
            st["overflowed_views"] += 1
        return memoryview(img)

    def poll(self, state, bg, training_done: bool = False,
             source_path: str = "", signal=None) -> bool:
        """One poll step; mirrors ``train.py:103-119``. `state` is the
        store, or a function that returns it (called once per render).
        Returns whether training should continue: the GUI holds it by
        sending ``train: false``, or ``keep_alive`` before training is
        done, and the poll then serves its next request.

        On a grid `signal(code)` runs before each render (RENDER) and every
        PAUSE_BEAT_S while the poll waits on a connected GUI (PAUSE). A
        request that fails drops the connection, which a later poll
        accepts anew (the reference's behaviour): ``stats["errors"]``
        counts failures, with their tracebacks, ``stats["disconnects"]``
        connections that the GUI closed or broke."""
        if self.conn is None:
            self._try_connect()
        keep_training = True
        while self.conn is not None:
            try:
                if signal is not None:
                    self._wait(signal)
                message = self._read()
                cam = _decode_camera(message, self.device)
                do_training = bool(message.get("train", True))
                keep_alive = bool(message.get("keep_alive", False))
                scaling_mod = float(message.get("scaling_modifier", 1.0))
                image_bytes = None
                if cam is not None:
                    if signal is not None:
                        signal(RENDER)
                    image_bytes = self._render(cam, state, bg, scaling_mod)
                self._send(image_bytes, source_path)
                keep_training = do_training
                if do_training and (not keep_alive or training_done):
                    break
            except ConnectionError:
                self._drop()
                self.stats["disconnects"] += 1
            except Exception:
                self._drop()
                self.stats["errors"] += 1
                traceback.print_exc()
        return keep_training

    def _drop(self):
        try:
            self.conn.close()
        except OSError:
            pass
        self.conn = None

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()


def broadcast_code(code: int, device) -> int:
    """Rank 0's `code`, on every rank of the default process group (one
    int32 on `device`, the group's). Rank 0 only enqueues the broadcast
    and returns its own code, so its host does not wait on the card."""
    t = torch.full((1,), code, dtype=torch.int32, device=device)
    dist.broadcast(t, src=0)
    return code if dist.get_rank() == 0 else int(t)


def follow(device, gather) -> None:
    """A rank other than 0 during rank 0's poll: run `gather` (the
    collective that a render needs) at each RENDER, until IDLE."""
    while True:
        code = broadcast_code(IDLE, device)
        if code == IDLE:
            return
        if code == RENDER:
            gather()
