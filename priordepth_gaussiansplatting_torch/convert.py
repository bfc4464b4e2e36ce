"""COLMAP SfM pipeline (counterpart of the root ``convert.py``): feature
extraction, matching, mapper and undistortion, the ``sparse/*`` move into
``sparse/0``, and the optional ``images_2/4/8`` resizes.

    python -m priordepth_gaussiansplatting_torch.convert -s <dir>
        [--no_gpu] [--skip_matching] [--camera OPENCV]
        [--colmap_executable PATH] [--resize] [--magick_executable PATH]

The same flags and command lines as the root script. It shells out to
``colmap`` and ImageMagick (``magick`` or ``convert``), and resizes with
PIL's LANCZOS where ImageMagick is absent. It touches no device. A command
that fails ends the process with that command's own exit code (the root
script exits with ``os.system``'s wait status, which ``sys.exit`` reports
as 0 for a command that exited with 1).
"""

from __future__ import annotations

import os
import shutil
import sys
from argparse import ArgumentParser

from .utils.shell import system


def run(cmd: str) -> None:
    code = system(cmd)
    if code != 0:
        print(f"command failed (exit code {code}): {cmd}", flush=True)
        sys.exit(code)


def resize_dir(src_dir: str, dst_dir: str, percent: int,
               magick: str) -> None:
    os.makedirs(dst_dir, exist_ok=True)
    for f in os.listdir(src_dir):
        src = os.path.join(src_dir, f)
        dst = os.path.join(dst_dir, f)
        if magick:
            run(f'{magick} "{src}" -resize {percent}% "{dst}"')
        else:
            from PIL import Image  # noqa: PLC0415
            with Image.open(src) as im:
                w, h = im.size
                im.resize((round(w * percent / 100),
                           round(h * percent / 100)),
                          Image.Resampling.LANCZOS).save(dst)


def move_into_sparse0(src: str) -> None:
    """Move ``<src>/sparse/*`` into ``<src>/sparse/0`` (the undistorter
    writes the model's files flat into ``sparse/``)."""
    os.makedirs(f"{src}/sparse/0", exist_ok=True)
    for f in os.listdir(f"{src}/sparse"):
        if f == "0":
            continue
        shutil.move(f"{src}/sparse/{f}", f"{src}/sparse/0/{f}")


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="")
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or shutil.which("colmap") or "colmap"
    magick = args.magick_executable or shutil.which("magick") \
        or shutil.which("convert") or ""
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(f"{src}/distorted/sparse", exist_ok=True)
        run(f"{colmap} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}")
        run(f"{colmap} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}")
        run(f"{colmap} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001")

    run(f"{colmap} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        f" --output_type COLMAP")

    move_into_sparse0(src)

    if args.resize:
        for name, pct in (("images_2", 50), ("images_4", 25),
                          ("images_8", 12)):
            resize_dir(f"{src}/images", f"{src}/{name}", pct, magick)
    print("Done.")


if __name__ == "__main__":
    main(sys.argv[1:])
