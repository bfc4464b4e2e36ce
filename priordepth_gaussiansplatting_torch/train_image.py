"""Image folder to trained model (counterpart of the root
``train_image.py``): COLMAP through the port's ``convert``, the
DepthAnythingV2 inverse-depth PNGs, the depth-scale fit
(``data/depth_scale.py``), then the port's train CLI with the prior.

    python -m priordepth_gaussiansplatting_torch.train_image -s <dir>
        [-m <model>] [--depth_anything_dir <DepthAnythingV2 checkout>]
        [--skip_colmap] [--train_args "<train CLI flags>"]

The same flags and command lines as the root script, with the root's
``convert.py`` and ``train.py`` replaced by
``python -m priordepth_gaussiansplatting_torch.{convert,train}``. The
depth command runs ``run.py`` of the checkout the user names, as the
root script does. ``--train_args`` reaches the train CLI through the
shell unchanged (``--data_device cpu`` there selects the CPU).
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

from .utils.shell import entry, run


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--model_path", "-m", default="")
    parser.add_argument("--depth_anything_dir", default="",
                        help="checkout of DepthAnythingV2 (run.py); skip "
                             "depth generation if empty and depths exist")
    parser.add_argument("--skip_colmap", action="store_true")
    parser.add_argument("--train_args", default="")
    args = parser.parse_args(argv)
    src = args.source_path

    if not args.skip_colmap:
        run(f"{entry('convert')} -s {src}")

    depths_dir = os.path.join(src, "depths")
    if args.depth_anything_dir:
        # The reference recipe: vitl, grayscale, pred-only.
        run(f"{sys.executable} {args.depth_anything_dir}/run.py "
            f"--encoder vitl --pred-only --grayscale "
            f"--img-path {src}/images --outdir {depths_dir}")
    if os.path.isdir(depths_dir):
        from .data.depth_scale import make_depth_scale  # noqa: PLC0415
        make_depth_scale(src, depths_dir)
        depth_flag = " -d depths"
    else:
        print("no depths dir; training without depth prior")
        depth_flag = ""

    model_flag = f" -m {args.model_path}" if args.model_path else ""
    run(f"{entry('train')} -s {src}{model_flag}{depth_flag} "
        f"{args.train_args}")


if __name__ == "__main__":
    main(sys.argv[1:])
