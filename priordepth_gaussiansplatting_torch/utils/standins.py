"""Stand-ins for the tools that the chain CLIs shell out to (ffmpeg, COLMAP,
DepthAnythingV2's ``run.py``, the SIBR app), for the tests and the chip
smoke run, where none of them is installed.

:func:`write_chain_standins` writes each as a small executable script that
calls :func:`main` of this module. A stand-in loads this file and
``data/colmap.py`` by path, not through the package (whose import loads
torch), so that it starts in a fraction of a second; the ``run.py``
stand-in alone imports the port (the depth model).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import numpy as np

if __package__:
    from ..data import colmap as cm
else:  # loaded by a stand-in script, after data/colmap.py as "colmap"
    import colmap as cm

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDINS = ("ffmpeg", "colmap", "colmap_fail", "depth_anything/run.py",
            "viewer/SIBR_gaussianViewer_app")
SCRIPT = '''#!{python}
"""Stand-in for `{tool}` (priordepth_gaussiansplatting_torch/utils/
standins.py)."""
import importlib.util
import sys


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    sys.modules[name] = mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sys.path.append({repo!r})
load("colmap", {colmap!r})
sys.exit(load("standins", {standins!r}).main({tool!r}, {cfg!r},
                                               sys.argv[1:]))
'''


def observed_model(sparse: str, names=None) -> tuple:
    """(cameras, images, points) of the COLMAP model in `sparse`, each
    image given 2D observations: every sparse point that projects into it
    in front of the camera (occlusion not tested). With `names`, the
    images, in id order, take those names."""
    cameras, images, points = cm.read_model(sparse, prefer_native=False)
    ids = np.array(sorted(points))
    xyz = np.stack([points[i].xyz for i in ids])
    names = dict(zip(sorted(images), names)) if names is not None else {}
    out = {}
    for key, im in images.items():
        cam = cameras[im.camera_id]
        fx, fy, cx, cy = cam.params[:4]
        pc = xyz @ cm.qvec2rotmat(im.qvec).T + im.tvec
        front = pc[:, 2] > 1e-6
        z = np.where(front, pc[:, 2], 1.0)
        uv = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], 1)
        keep = (front & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
                & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
        out[key] = cm.ColmapImage(im.id, im.qvec, im.tvec, im.camera_id,
                                  names.get(key, im.name), uv[keep],
                                  ids[keep].astype(np.int64))
    return cameras, out, points


def write_chain_standins(bin_dir: str, scene: str, depth_device=None,
                         depth_seed: int = 0) -> dict:
    """Executable stand-ins, under `bin_dir`, acting out a capture of the
    raycast `scene` (images/ and sparse/0 of the port's
    ``make_synthetic_scene``). Each appends what it was asked and did to
    ``<bin_dir>/standins.jsonl`` and prints it:

    - ``ffmpeg -i V ... OUT%04d.jpg``: the scene's images, in name order,
      as the frames 0001.jpg, ... (JPEG quality 95);
    - ``colmap feature_extractor|exhaustive_matcher``: touch the
      database; ``mapper``: the scene's model, its images renamed to the
      frames of ``--image_path`` and given 2D observations
      (:func:`observed_model`), into ``<output_path>/0``;
      ``image_undistorter``: the frames into ``<output_path>/images`` and
      the model's files flat into ``<output_path>/sparse``;
    - ``colmap_fail``: a COLMAP that exits with 3;
    - ``depth_anything/run.py``: the reference's flags; the priors of the
      port's ``generate_depth_priors`` with the repo's depth configuration
      and weights from `depth_seed`, on `depth_device` (the card unless
      the caller names the CPU);
    - ``viewer/SIBR_gaussianViewer_app``: records its arguments.

    Returns {"path": the directory to put first on PATH, "colmap_fail",
    "depth_anything_dir", "viewer_dir", "log"}."""
    log = os.path.join(bin_dir, "standins.jsonl")
    cfg = dict(scene=os.path.abspath(scene), log=log, seed=depth_seed,
               device=None if depth_device is None else str(depth_device))
    paths = dict(repo=os.path.dirname(PACKAGE_DIR),
                 colmap=os.path.join(PACKAGE_DIR, "data", "colmap.py"),
                 standins=os.path.abspath(__file__))
    for tool in STANDINS:
        script = os.path.join(bin_dir, tool)
        os.makedirs(os.path.dirname(script), exist_ok=True)
        with open(script, "w") as f:
            f.write(SCRIPT.format(python=sys.executable, tool=tool,
                                  cfg=cfg, **paths))
        os.chmod(script, 0o755)
    return dict(path=bin_dir, colmap_fail=os.path.join(bin_dir,
                                                       "colmap_fail"),
                depth_anything_dir=os.path.join(bin_dir, "depth_anything"),
                viewer_dir=os.path.join(bin_dir, "viewer"), log=log)


def read_log(log: str) -> list:
    """The stand-ins' records, in the order they ran."""
    with open(log) as f:
        return [json.loads(line) for line in f]


def _options(argv) -> dict:
    """``--key value`` and ``--key=value`` pairs of `argv`."""
    out, i = {}, 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("-") and "=" in arg:
            key, val = arg.split("=", 1)
            out[key] = val
        elif arg.startswith("-") and i + 1 < len(argv) \
                and not argv[i + 1].startswith("--"):
            out[arg] = argv[i + 1]
            i += 1
        else:
            out[arg] = True
        i += 1
    return out


def _colmap(cmd: str, opt: dict, scene: str, rec: dict) -> int:
    if cmd in ("feature_extractor", "exhaustive_matcher"):
        with open(opt["--database_path"], "ab"):
            pass
        rec["did"] = f"touched {opt['--database_path']}"
    elif cmd == "mapper":
        out = os.path.join(opt["--output_path"], "0")
        os.makedirs(out, exist_ok=True)
        frames = sorted(os.listdir(opt["--image_path"]))
        cameras, images, points = observed_model(
            os.path.join(scene, "sparse", "0"), frames)
        cm.write_cameras_binary(cameras, os.path.join(out, "cameras.bin"))
        cm.write_images_binary(images, os.path.join(out, "images.bin"))
        cm.write_points3D_binary(points, os.path.join(out, "points3D.bin"))
        rec["observations"] = [len(im.point3D_ids) for im in images.values()]
        rec["did"] = (f"wrote the scene's model ({len(images)} images, "
                      f"{len(points)} points) to {out}")
    elif cmd == "image_undistorter":
        dst = opt["--output_path"]
        shutil.copytree(opt["--image_path"], os.path.join(dst, "images"),
                        dirs_exist_ok=True)
        os.makedirs(os.path.join(dst, "sparse"), exist_ok=True)
        for f in sorted(os.listdir(opt["--input_path"])):
            shutil.copy(os.path.join(opt["--input_path"], f),
                        os.path.join(dst, "sparse", f))
        rec["did"] = f"copied the frames and the model into {dst}"
    else:
        return 2
    return 0


def _depth_anything(opt: dict, cfg: dict, rec: dict) -> None:
    import torch  # noqa: PLC0415

    from priordepth_gaussiansplatting_torch.depth import (  # noqa: PLC0415
        config, infer)
    from priordepth_gaussiansplatting_torch.device import (  # noqa: PLC0415
        resolve_device)
    device = resolve_device(cfg["device"])
    model = config.build_model(
        config.get_config("depth", "infer", "nyu"),
        generator=torch.Generator().manual_seed(cfg["seed"]),
        device=device).eval()
    written = infer.generate_depth_priors(model, opt["--img-path"],
                                          opt["--outdir"], device=device)
    rec.update(device=str(device), written=len(written),
               did=f"wrote {len(written)} priors to {opt['--outdir']}")
    if device.type == "cuda":
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30


def main(tool: str, cfg: dict, argv) -> int:
    """What the stand-in `tool` does with `argv`; its exit code."""
    t0 = time.perf_counter()
    rec = dict(tool=tool, argv=list(argv))
    opt = _options(argv)
    code = 0
    if tool == "ffmpeg":
        from PIL import Image  # noqa: PLC0415
        images = os.path.join(cfg["scene"], "images")
        names = sorted(os.listdir(images))
        for i, name in enumerate(names):
            with Image.open(os.path.join(images, name)) as im:
                im.convert("RGB").save(argv[-1] % (i + 1), quality=95)
        rec["did"] = f"wrote {len(names)} frames of {cfg['scene']}"
    elif tool == "colmap":
        code = _colmap(argv[0], opt, cfg["scene"], rec)
    elif tool == "colmap_fail":
        code = 3
    elif tool == "depth_anything/run.py":
        _depth_anything(opt, cfg, rec)
    else:
        rec["did"] = "recorded its arguments"
    rec.update(code=code, seconds=time.perf_counter() - t0)
    print(f"stand-in {tool}: {rec.get('did', f'exit {code}')}", flush=True)
    with open(cfg["log"], "a") as f:
        f.write(json.dumps(rec) + "\n")
    return code
