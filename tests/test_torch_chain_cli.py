"""The port's chain CLIs (``convert``, ``train_image``, ``train_video``,
``SIBR_viewer``) against the root scripts on the CPU.

With ``os.system`` recorded, each case gives both the same commands, the
port's entry points (``python -m priordepth_gaussiansplatting_torch.<name>``)
in place of the root's ``<name>.py``; the ``sparse/*`` move and the PIL
resizes act on real directories and give the same files, byte for byte,
and the port's ``train_image`` fits the same ``depth_params.json`` as the
JAX package's ``make_depth_scale``. The one intended difference is the exit
code after a failed command: the root ``convert.py`` and ``SIBR_viewer.py``
report the wait status (``sys.exit(768)`` exits with 0), the port the
command's own code. Last, one chain end to end through executable
stand-ins for ffmpeg, COLMAP, DepthAnythingV2's ``run.py`` and the SIBR app
(``utils/standins.py``), the train CLI on the CPU.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import SIBR_viewer as root_sibr
import convert as root_convert
import train_image as root_train_image
import train_video as root_train_video
from priordepth_gaussiansplatting_torch import SIBR_viewer as port_sibr
from priordepth_gaussiansplatting_torch import convert as port_convert
from priordepth_gaussiansplatting_torch import make_synthetic_scene as mss
from priordepth_gaussiansplatting_torch import train_image as port_train_image
from priordepth_gaussiansplatting_torch import train_video as port_train_video
from priordepth_gaussiansplatting_torch.data import colmap as pcm
from priordepth_gaussiansplatting_torch.utils import standins as SI
from priordepth_gaussiansplatting_torch.utils import testing as PT

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "priordepth_gaussiansplatting_torch"
PY = sys.executable
SCRIPTS = ("convert", "train", "train_image", "render", "metrics")
MODEL_FILES = ("cameras.bin", "images.bin", "points3D.bin")
# A wait status of 3 << 8: the command exited with 3.
FAILED = 3 << 8


def as_port(cmd: str) -> str:
    """A root script's command with the port's entry point in place of
    ``<name>.py``."""
    for name in SCRIPTS:
        root = f"{PY} {name}.py"
        if cmd == root or cmd.startswith(root + " "):
            return f"{PY} -m {PACKAGE}.{name}" + cmd[len(root):]
    return cmd


def recorded(monkeypatch, status=lambda cmd: 0):
    seen = []

    def system(cmd):
        seen.append(cmd)
        return status(cmd)
    monkeypatch.setattr(os, "system", system)
    return seen


def both(monkeypatch, root_main, port_main, argv, status=lambda cmd: 0):
    """(root commands, port commands, root result, port result)."""
    seen = recorded(monkeypatch, status)
    want_ret = root_main(list(argv))
    want = list(seen)
    seen.clear()
    got_ret = port_main(list(argv))
    return want, list(seen), want_ret, got_ret


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 32², 4-view raycast scene whose images carry 2D observations,
    with its true inverse depths as 16-bit priors under ``depths/``."""
    root = str(tmp_path_factory.mktemp("scene") / "scene")
    mss.main(root, 32, 4, n_points=200)
    sparse = os.path.join(root, "sparse", "0")
    _, images, _ = SI.observed_model(sparse)
    pcm.write_images_binary(images, os.path.join(sparse, "images.bin"))
    PT.write_depth_priors(root, 32, 4)
    return root


def no_depths(tmp_path) -> str:
    src = str(tmp_path / "src")
    os.makedirs(src)
    return src


TRAIN_IMAGE = {
    "default": [],
    "skip_colmap": ["--skip_colmap"],
    "depth_anything": ["--depth_anything_dir", "/ext/Depth-Anything-V2"],
    "model_and_train_args": ["-m", "/out/model", "--train_args",
                             "--iterations 10 --data_device cpu --eval"],
}


@pytest.mark.parametrize("case", sorted(TRAIN_IMAGE))
def test_train_image_commands(case, tmp_path, monkeypatch):
    argv = ["-s", no_depths(tmp_path)] + TRAIN_IMAGE[case]
    want, got, _, _ = both(monkeypatch, root_train_image.main,
                           port_train_image.main, argv)
    assert got == [as_port(c) for c in want]
    assert len(got) == {"skip_colmap": 1, "depth_anything": 3}.get(case, 2)
    assert not any(".py " in c and "run.py" not in c for c in got), got


@pytest.mark.parametrize("skip_colmap", [False, True])
def test_train_image_with_depths_fits_jax_depth_params(scene, skip_colmap,
                                                      monkeypatch):
    """An existing ``depths/``: both add ``-d depths`` and write
    ``depth_params.json``; the port's fit equals the JAX package's."""
    argv = ["-s", scene, "-m", "/out/m"] + (["--skip_colmap"] if skip_colmap
                                            else [])
    dp = os.path.join(scene, "sparse", "0", "depth_params.json")
    seen = recorded(monkeypatch)
    root_train_image.main(argv)
    with open(dp) as f:
        want_params = json.load(f)
    want = list(seen)
    seen.clear()
    os.remove(dp)
    port_train_image.main(argv)
    with open(dp) as f:
        got_params = json.load(f)
    assert seen == [as_port(c) for c in want]
    assert " -d depths " in seen[-1]
    assert sorted(got_params) == sorted(want_params) == [
        f"r_{i:03d}" for i in range(4)]
    for name, p in want_params.items():
        assert p["scale"] != 0 and np.isfinite(list(p.values())).all()
        for key in ("scale", "offset"):
            assert got_params[name][key] == pytest.approx(p[key], rel=1e-6,
                                                          abs=1e-9)


TRAIN_VIDEO = {
    "fps": ["--fps", "5"],
    "depth_anything": ["--depth_anything_dir", "/ext/DA2", "--train_args",
                       "-m /out/m --iterations 7"],
}


@pytest.mark.parametrize("case", sorted(TRAIN_VIDEO))
def test_train_video_commands(case, tmp_path, monkeypatch):
    argv = ["-v", "/videos/clip.mp4", "-w", str(tmp_path / "w")] \
        + TRAIN_VIDEO[case]
    want, got, _, _ = both(monkeypatch, root_train_video.main,
                           port_train_video.main, argv)
    assert got == [as_port(c) for c in want] and len(got) == 2
    fps = float(argv[argv.index("--fps") + 1]) if "--fps" in argv else 2.0
    assert got[0].split(" -i ")[1] == (
        f'"/videos/clip.mp4" -qscale:v 1 -qmin 1 -vf fps={fps} '
        f'"{tmp_path}/w/input/%04d.jpg"')
    assert got[1].startswith(f"{PY} -m {PACKAGE}.train_image -s ")
    assert os.path.isdir(tmp_path / "w" / "input")


def images_dir(src: str, n: int = 3) -> None:
    from PIL import Image
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(src, "images"))
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (37 + i, 53, 3), np.uint8)).save(
            os.path.join(src, "images", f"im{i}.png"))


CONVERT = {
    "default": [],
    "skip_matching": ["--skip_matching"],
    "no_gpu_camera": ["--no_gpu", "--camera", "PINHOLE"],
    "colmap_executable": ["--colmap_executable", "/ext/colmap/bin/colmap"],
    "resize_magick": ["--resize", "--magick_executable", "/ext/im/magick"],
}


@pytest.mark.parametrize("case", sorted(CONVERT))
def test_convert_commands(case, tmp_path, monkeypatch):
    srcs = []
    for side in ("root", "port"):
        src = str(tmp_path / side)
        os.makedirs(os.path.join(src, "sparse"))
        images_dir(src)
        srcs.append(src)
    seen = recorded(monkeypatch)
    root_convert.main(["-s", srcs[0]] + CONVERT[case])
    want = [c.replace(srcs[0], srcs[1]) for c in seen]
    seen.clear()
    port_convert.main(["-s", srcs[1]] + CONVERT[case])
    assert seen == want
    n = {"default": 4, "no_gpu_camera": 4, "colmap_executable": 4,
         "skip_matching": 1, "resize_magick": 4 + 9}[case]
    assert len(seen) == n, seen
    if case == "resize_magick":
        assert seen[-1].startswith('/ext/im/magick "') and "% " in seen[-1]


def test_convert_resizes_with_pil_as_the_root_script(tmp_path, monkeypatch):
    """No ImageMagick: PIL's LANCZOS writes the same bytes."""
    real_which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name: None if name in (
        "magick", "convert") else real_which(name))
    recorded(monkeypatch)
    trees = {}
    for side, mod in (("root", root_convert), ("port", port_convert)):
        src = str(tmp_path / side)
        os.makedirs(os.path.join(src, "sparse"))
        images_dir(src)
        mod.main(["-s", src, "--skip_matching", "--resize"])
        trees[side] = {
            os.path.relpath(os.path.join(d, f), src):
                open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(src) for f in files}
    assert trees["port"] == trees["root"]
    assert sum(k.startswith("images_") for k in trees["port"]) == 9


def test_sparse_move_on_a_real_directory(tmp_path, monkeypatch):
    recorded(monkeypatch)
    trees = {}
    for side, mod in (("root", root_convert), ("port", port_convert)):
        src = tmp_path / side
        (src / "sparse").mkdir(parents=True)
        for i, name in enumerate(MODEL_FILES + ("project.ini",)):
            (src / "sparse" / name).write_bytes(bytes([i]) * (10 + i))
        mod.main(["-s", str(src), "--skip_matching"])
        trees[side] = sorted(
            (os.path.relpath(os.path.join(d, f), src),
             open(os.path.join(d, f), "rb").read())
            for d, _, files in os.walk(src) for f in files)
    assert trees["port"] == trees["root"]
    assert [p for p, _ in trees["port"]] == [
        os.path.join("sparse", "0", f) for f in sorted(
            MODEL_FILES + ("project.ini",))]


SIBR = {
    "app_found": dict(metrics=False, app=True),
    "app_found_with_metrics": dict(metrics=True, app=True),
    "app_missing": dict(metrics=False, app=False),
    "app_missing_with_metrics": dict(metrics=True, app=False),
}


@pytest.mark.parametrize("case", sorted(SIBR))
def test_sibr_viewer_commands(case, tmp_path, monkeypatch, capsys):
    viewer = tmp_path / "sibr"
    viewer.mkdir()
    if SIBR[case]["app"]:
        (viewer / "SIBR_gaussianViewer_app").write_text("")
    argv = ["-m", "/out/model", "--viewer_path", str(viewer)] + (
        ["--with_metrics"] if SIBR[case]["metrics"] else [])
    want, got, want_ret, got_ret = both(monkeypatch, root_sibr.main,
                                        port_sibr.main, argv)
    assert got == [as_port(c) for c in want]
    assert got_ret == want_ret == (0 if SIBR[case]["app"] else 1)
    assert len(got) == 2 * SIBR[case]["metrics"] + SIBR[case]["app"]
    if not SIBR[case]["app"]:
        out = capsys.readouterr().out
        assert out.count("SIBR viewer binary not found") == 2


def test_failed_commands_end_the_port_non_zero(tmp_path, monkeypatch):
    """The root scripts' wait status against the port's exit code, in
    process: SIBR_viewer with a failing render, a failing app; train_image
    and train_video raise with the command's code."""
    viewer = tmp_path / "sibr"
    viewer.mkdir()
    (viewer / "SIBR_gaussianViewer_app").write_text("")
    argv = ["-m", "/m", "--viewer_path", str(viewer), "--with_metrics"]
    _, _, want_ret, got_ret = both(
        monkeypatch, root_sibr.main, port_sibr.main, argv,
        lambda cmd: FAILED if "render" in cmd else 0)
    assert (want_ret, got_ret) == (0, 3)
    _, _, want_ret, got_ret = both(
        monkeypatch, root_sibr.main, port_sibr.main, argv,
        lambda cmd: FAILED if "SIBR_gaussianViewer_app" in cmd else 0)
    assert (want_ret, got_ret) == (FAILED, 3)
    recorded(monkeypatch, lambda cmd: FAILED)
    with pytest.raises(RuntimeError, match=r"exit code 3\): .*convert"):
        port_train_image.main(["-s", no_depths(tmp_path)])
    with pytest.raises(RuntimeError, match=r"exit code 3\): .*ffmpeg"):
        port_train_video.main(["-v", "v.mp4", "-w", str(tmp_path / "w")])
    with pytest.raises(SystemExit) as e:
        port_convert.main(["-s", no_depths(tmp_path / "c")])
    assert e.value.code == 3


def test_a_failing_colmap_ends_convert_with_its_code(tmp_path):
    """As processes: the root ``convert.py`` exits 0 after COLMAP exits
    with 3 (``sys.exit`` of the wait status 768), the port's with 3."""
    st = SI.write_chain_standins(str(tmp_path / "bin"), str(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    rcs = {}
    for side, cmd in (("root", [PY, "convert.py"]),
                      ("port", [PY, "-m", f"{PACKAGE}.convert"])):
        src = str(tmp_path / side)
        out = subprocess.run(cmd + ["-s", src, "--colmap_executable",
                                    st["colmap_fail"]],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert "feature_extractor" in out.stdout, out.stderr
        assert "exhaustive_matcher" not in out.stdout
        rcs[side] = out.returncode
    assert rcs == {"root": 0, "port": 3}
    assert [r["code"] for r in SI.read_log(st["log"])] == [3, 3]


def test_chain_end_to_end_through_stand_ins(tmp_path):
    """train_video -> train_image -> convert (stand-in COLMAP) -> stand-in
    ``run.py`` -> make_depth_scale -> the train CLI on the CPU, then
    SIBR_viewer with the stand-in app."""
    scene = str(tmp_path / "scene")
    mss.main(scene, 32, 4, n_points=200)
    st = SI.write_chain_standins(str(tmp_path / "bin"), scene,
                                 depth_device="cpu")
    video, work, model = (str(tmp_path / n) for n in ("v.mp4", "w", "m"))
    with open(video, "wb") as f:
        f.write(b"stand-in video")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               PATH=st["path"] + os.pathsep + os.environ["PATH"])
    train_args = ("--data_device cpu --eval --disable_viewer --iterations 3 "
                  f"--test_iterations 3 --save_iterations 3 -m {model}")
    out = subprocess.run(
        [PY, "-m", f"{PACKAGE}.train_video", "-v", video, "-w", work,
         "--fps", "2", "--depth_anything_dir", st["depth_anything_dir"],
         "--train_args", train_args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    cmds = [ln[2:] for ln in out.stdout.splitlines() if ln.startswith("$ ")]
    heads = [c.split(" --")[0].split(" -s ")[0].split(" -i ")[0]
             for c in cmds]
    colmap = os.path.join(st["path"], "colmap")
    assert heads == [
        os.path.join(st["path"], "ffmpeg"), f"{PY} -m {PACKAGE}.train_image",
        f"{PY} -m {PACKAGE}.convert", f"{colmap} feature_extractor",
        f"{colmap} exhaustive_matcher", f"{colmap} mapper",
        f"{colmap} image_undistorter",
        f"{PY} {st['depth_anything_dir']}/run.py",
        f"{PY} -m {PACKAGE}.train"], heads
    log = SI.read_log(st["log"])
    assert [r["tool"] for r in log] == ["ffmpeg"] + ["colmap"] * 4 + [
        "depth_anything/run.py"]
    assert all(r["code"] == 0 for r in log) and log[-1]["device"] == "cpu"
    assert min(log[3]["observations"]) > 10, log[3]
    # The loader adds the initial point cloud, points3D.ply.
    assert sorted(os.listdir(os.path.join(work, "sparse", "0"))) == sorted(
        MODEL_FILES + ("depth_params.json", "points3D.ply"))
    assert sorted(os.listdir(os.path.join(work, "depths"))) == [
        f"{i:04d}.png" for i in range(1, 5)]
    with open(os.path.join(work, "sparse", "0", "depth_params.json")) as f:
        params = json.load(f)
    assert sorted(params) == [f"{i:04d}" for i in range(1, 5)]
    assert all(np.isfinite(list(p.values())).all() for p in params.values())
    assert f" -d depths --data_device cpu" in cmds[-1]
    last = out.stdout.strip().splitlines()[-1]
    res = json.loads(last[len("Training complete: "):])
    assert res["iterations_run"] == 3 and res["skipped"] == 0
    assert np.isfinite(res["final_loss"])
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_3",
                                       "point_cloud.ply"))
    out = subprocess.run(
        [PY, "-m", f"{PACKAGE}.SIBR_viewer", "-m", model, "--viewer_path",
         st["viewer_dir"]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    app = SI.read_log(st["log"])[-1]
    assert app["tool"] == "viewer/SIBR_gaussianViewer_app"
    assert app["argv"] == ["-m", model]
