"""Video to trained model (counterpart of the root ``train_video.py``):
ffmpeg frames at a chosen rate into ``<workdir>/input``, then the port's
``train_image`` chain (COLMAP, depth prior, training).

    python -m priordepth_gaussiansplatting_torch.train_video -v <video>
        -w <workdir> [--fps 2] [--depth_anything_dir <dir>]
        [--train_args "<train CLI flags>"]

The same flags and command lines as the root script, with its
``train_image.py`` replaced by
``python -m priordepth_gaussiansplatting_torch.train_image``.
"""

from __future__ import annotations

import os
import shutil
import sys
from argparse import ArgumentParser

from .utils.shell import entry, run


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--video", "-v", required=True)
    parser.add_argument("--workdir", "-w", required=True)
    parser.add_argument("--fps", type=float, default=2.0)
    parser.add_argument("--depth_anything_dir", default="")
    parser.add_argument("--train_args", default="")
    args = parser.parse_args(argv)

    ffmpeg = shutil.which("ffmpeg") or "ffmpeg"
    input_dir = os.path.join(args.workdir, "input")
    os.makedirs(input_dir, exist_ok=True)
    run(f'{ffmpeg} -i "{args.video}" -qscale:v 1 -qmin 1 '
        f'-vf fps={args.fps} "{input_dir}/%04d.jpg"')

    da = f" --depth_anything_dir {args.depth_anything_dir}" \
        if args.depth_anything_dir else ""
    run(f"{entry('train_image')} -s {args.workdir}{da} "
        f"--train_args \"{args.train_args}\"")


if __name__ == "__main__":
    main(sys.argv[1:])
