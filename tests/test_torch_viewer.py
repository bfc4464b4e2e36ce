"""The port's network viewer (``viewer/network_gui.py``) on the CPU:
byte-compatible with the JAX package's server over loopback (the same
state and camera message to each: equal decoded cameras, images within one
level of 255, equal verify strings), the ``train``/``keep_alive`` flags and
the reconnection after a malformed message in both packages, and the train
CLI with the viewer on, on one rank (a client pauses it) and on a 2-rank
gloo grid (only rank 0 binds; a request is answered). A server made here
binds port 0 and its client dials the port it got; a client that dials
before its server has bound (the grid's rank 0) dials a port below the
kernel's ephemeral range, which no other test's gloo listener can hold."""

import json
import os
import queue
import socket
import threading

import jax.numpy as jnp
import numpy as np
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.data import dataset as pds
from priordepth_gaussiansplatting_torch.train import __main__ as train_cli
from priordepth_gaussiansplatting_torch.utils import testing as T
from priordepth_gaussiansplatting_torch.viewer import network_gui as pgui
from priordepth_gaussiansplatting_tpu.models.gaussians import (GaussianParams,
                                                               GaussianState)
from priordepth_gaussiansplatting_tpu.utils import testing as JT
from priordepth_gaussiansplatting_tpu.viewer import network_gui as jgui
from test_torch_mesh_trainer import make_scene as grid_scene
from test_torch_trainer import make_scene
from tests.test_torch_render import stored_params

torch.set_num_threads(2)
SOURCE = "/data/scenes/garden"


def states(n=256, seed=21):
    """The same store in both packages (SH degree 3, some rows off)."""
    params = stored_params(seed, n)
    active = np.random.default_rng(seed).random(n) > 0.1
    state_j = GaussianState(
        params=GaussianParams(**{k: jnp.asarray(v)
                                 for k, v in params.items()}),
        active=jnp.asarray(active), max_radii2d=jnp.zeros(n),
        xyz_gradient_accum=jnp.zeros(n), denom=jnp.zeros(n),
        active_sh_degree=jnp.asarray(3, jnp.int32), max_sh_degree=3)
    return state_j, interop.gaussian_state_from_numpy(params, active, 3, 3,
                                                      device="cpu")


def message(w=72, h=56, **flags):
    cam = JT.look_at_camera((0.3, -0.2, -2.5), width=w, height=h)
    port_cam = interop.camera_from_numpy(
        np.asarray(cam.world_view), np.asarray(cam.full_proj),
        np.asarray(cam.cam_center), w, h, cam.fovx, cam.fovy, device="cpu")
    return T.camera_message(port_cam, **flags)


def serve(gui, state, bg, requests, **poll_kw):
    """One poll of `gui` while a client sends `requests` (dicts, or raw
    bytes sent as they are); (what poll returned, the client's replies or
    the exception that ended them). A connection of the last call, which
    its client has closed, is dropped first by a poll, as the train loop's
    next poll would."""
    if gui.conn is not None:
        gui.poll(state, bg)
        assert gui.conn is None
    client = T.ViewerClient("127.0.0.1", gui.listener.getsockname()[1])
    replies = []

    def run():
        try:
            for req in requests:
                if isinstance(req, bytes):
                    client.sock.sendall(req)
                    replies.append(client.sock.recv(1))  # b"": dropped
                else:
                    replies.append(client.request(req))
        except ConnectionError as e:
            replies.append(e)
        finally:
            client.close()
    th = threading.Thread(target=run)
    th.start()
    out = gui.poll(state, bg, **poll_kw)
    th.join(timeout=60)
    assert not th.is_alive()
    return out, replies


def servers():
    return (pgui.NetworkGUI("127.0.0.1", 0, device="cpu"),
            jgui.NetworkGUI("127.0.0.1", 0))


def test_loopback_matches_jax():
    state_j, state = states()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    port_gui, jax_gui = servers()
    try:
        for flags in ({}, {"scaling_modifier": 0.7}):
            msg = message(**flags)
            cam, cam_j = pgui._decode_camera(msg, "cpu"), \
                jgui._decode_camera(msg)
            for k in ("world_view", "full_proj", "cam_center"):
                np.testing.assert_array_equal(getattr(cam, k).numpy(),
                                              np.asarray(getattr(cam_j, k)))
            assert (cam.width, cam.height, cam.fovx, cam.fovy, cam.znear,
                    cam.zfar) == (cam_j.width, cam_j.height, cam_j.fovx,
                                  cam_j.fovy, cam_j.znear, cam_j.zfar)
            got = serve(port_gui, state, torch.from_numpy(bg), [msg],
                        source_path=SOURCE)
            want = serve(jax_gui, state_j, jnp.asarray(bg), [msg],
                         source_path=SOURCE)
            assert got[0] is want[0] is True
            (img, verify), (img_j, verify_j) = got[1][0], want[1][0]
            assert img.shape == img_j.shape == (56, 72, 3)
            assert verify == verify_j == SOURCE
            diff = np.abs(img.astype(int) - img_j.astype(int))
            assert diff.max() <= 1, diff.max()
            assert img.std() > 0
        assert port_gui.stats["renders"] == 2
        assert port_gui.stats["errors"] == 0
    finally:
        port_gui.close()
        jax_gui.close()


def test_flags_and_reconnection_match_jax():
    """``train: false`` holds the poll until a request trains again;
    ``keep_alive`` holds it until training is done; a malformed request
    drops the connection and a new one is accepted; a GUI that closes
    while holding training leaves the poll returning False. Both packages
    answer each sequence alike."""
    state_j, state = states(n=64)
    bg = np.zeros(3, np.float32)
    cam, no_cam = message(24, 16), message(24, 16)
    no_cam.update(resolution_x=0, resolution_y=0)
    hold = dict(cam, train=False)
    alive = dict(cam, keep_alive=True)
    bad = len(b"{oops").to_bytes(4, "little") + b"{oops"
    cases = [
        ([dict(no_cam, train=False), hold, dict(no_cam)], {}, True, 3),
        ([alive, alive, cam], {}, True, 3),
        ([alive], {"training_done": True}, True, 1),
        ([bad], {}, True, 1),
        ([cam], {}, True, 1),
        ([hold], {}, False, 1),
    ]
    port_gui, jax_gui = servers()
    try:
        for requests, kw, keep, n in cases:
            got = serve(port_gui, state, torch.from_numpy(bg), requests,
                        source_path=SOURCE, **kw)
            want = serve(jax_gui, state_j, jnp.asarray(bg), requests,
                         source_path=SOURCE, **kw)
            assert got[0] is want[0] is keep, requests
            assert len(got[1]) == len(want[1]) == n
            for g, w in zip(got[1], want[1]):
                if isinstance(g, tuple):
                    assert g[1] == w[1] == SOURCE
                    assert (g[0] is None) == (w[0] is None)
                else:
                    assert g == w == b""  # the server dropped us
        st = port_gui.stats
        assert st["errors"] == 1  # the malformed request
        assert st["renders"] == 1 + 3 + 1 + 1 + 1
        assert st["disconnects"] >= 1
    finally:
        port_gui.close()
        jax_gui.close()


def test_bind_failure_is_reported_and_training_goes_on(capsys):
    """A taken port: the CLI's viewer says so and stays off; with
    ``--disable_viewer`` nothing binds."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        args = train_cli.parser().parse_args(["-s", "x", "--port", str(port)])
        assert train_cli.open_viewer(args, torch.device("cpu")) == (None,
                                                                    False)
    assert "network GUI disabled" in capsys.readouterr().out
    args = train_cli.parser().parse_args(["-s", "x", "--disable_viewer"])
    assert train_cli.open_viewer(args, torch.device("cpu")) == (None, False)
    assert capsys.readouterr().out == ""


def test_train_cli_with_viewer_pauses_and_resumes(tmp_path, capsys,
                                                  monkeypatch):
    """A client holds training for three requests (the same iteration:
    equal images), resumes it, and its next request comes from a later
    iteration; the summary counts the renders apart from the steps. The
    CLI binds ``--port 0``; the client dials the port its viewer got."""
    root = make_scene(str(tmp_path / "scene"), views=3)
    cam = pds.Scene(root, shuffle=False, device="cpu").train_cameras[0]
    msg = T.camera_message(cam)
    bound, seen = queue.Queue(), {}
    open_viewer = train_cli.open_viewer

    def opened(*args, **kw):
        gui, on = open_viewer(*args, **kw)
        bound.put(gui.port)
        return gui, on
    monkeypatch.setattr(train_cli, "open_viewer", opened)

    def client():
        port = seen["port"] = bound.get(timeout=60)
        c = T.ViewerClient("127.0.0.1", port)
        try:
            seen["held"] = [c.request(dict(msg, train=False))[0]
                            for _ in range(3)]
            seen["resumed"] = c.request(msg)[0]
            seen["later"] = c.request(msg)[0]
        finally:
            c.close()
    th = threading.Thread(target=client)
    th.start()
    res = train_cli.main(
        ["-s", root, "-m", str(tmp_path / "m"), "--data_device", "cpu",
         "--backend", "kernels", "--quiet", "--port", "0",
         "--iterations", "40", "--test_iterations", "99",
         "--save_iterations", "99", "--noise_injection_iter", "0",
         "--floating_prune_iter", "0"])
    th.join(timeout=60)
    assert not th.is_alive()
    port = seen["port"]
    out = capsys.readouterr().out
    assert f"network viewer on 127.0.0.1:{port}" in out
    held = seen["held"]
    assert all(np.array_equal(h, held[0]) for h in held[1:])
    assert np.array_equal(seen["resumed"], held[0])
    assert not np.array_equal(seen["later"], held[0])
    v = res["viewer"]
    assert (v["renders"], v["errors"], v["disconnects"]) == (5, 0, 1)
    assert v["overflowed_views"] == 0 and v["port"] == port
    assert res["iterations_run"] == 40 and res["skipped"] == 0
    # on the CPU the wrappers take their plain versions: no launches
    assert res["step_launches"] == {} and v["launches"] == {}


def test_train_cli_grid_viewer_on_rank_zero(tmp_path, monkeypatch, capfd):
    """``--n_data 2`` over gloo: rank 0 alone binds, every rank joins the
    render's gather, and the request is answered."""
    root = grid_scene(str(tmp_path / "scene"))
    cam = pds.Scene(root, shuffle=False, device="cpu",
                    white_background=True).train_cameras[0]
    msg = T.camera_message(cam)
    for var in train_cli.GROUP_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(train_cli, "SPAWN_TIMEOUT", 120.0)
    port, seen = T.free_port_below_ephemeral(), {}

    def client():
        c = T.connect_viewer(port, deadline=100.0)
        try:
            seen["reply"] = c.request(msg)
        finally:
            c.close()
    th = threading.Thread(target=client)
    th.start()
    res = train_cli.main(
        ["-s", root, "-m", str(tmp_path / "m"), "-w", "--data_device",
         "cpu", "--n_data", "2", "--quiet", "--port", str(port),
         "--noise_injection_iter", "0", "--floating_prune_iter", "0",
         "--init_capacity", "512", "--iterations", "10",
         "--test_iterations", "99", "--save_iterations", "99"])
    th.join(timeout=60)
    assert not th.is_alive()
    out = capfd.readouterr().out
    assert out.count("network viewer on ") == 1
    assert "network GUI disabled" not in out
    image, verify = seen["reply"]
    assert image.shape == (cam.height, cam.width, 3) and image.std() > 0
    assert verify == os.path.abspath(root) or verify == root
    v = res["viewer"]
    assert (v["renders"], v["errors"]) == (1, 0)
    assert res["iterations_run"] == 10 and res["skipped"] == 0
    json.dumps(res)  # the summary line stays JSON
