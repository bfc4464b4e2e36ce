"""The benchmark over the 13 standard scenes (counterpart of the root
``full_eval.py``; reference ``full_eval.py``):

    python -m priordepth_gaussiansplatting_torch.full_eval \\
        -m360 <dir> -tat <dir> -db <dir> [--output_path ./eval] [flags]

MipNeRF360 x 9 (outdoor at images_4, indoor at images_2), Tanks&Temples
x 2, DeepBlending x 2, with the same flags (--skip_training,
--skip_rendering, --skip_metrics, --use_depth, --use_expcomp, --fast,
--aa) and the same command lines, each calling the port's entry point
(``python -m priordepth_gaussiansplatting_torch.{train,render,metrics}``)
where the root script calls ``train.py``, ``render.py`` or ``metrics.py``.
Training times per group go to ``<output_path>/timing.txt``.
"""

from __future__ import annotations

import os
import sys
import time
from argparse import ArgumentParser

from .utils.shell import entry, run

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump",
                             "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]


def main(argv=None):
    parser = ArgumentParser(description="Full evaluation script")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--use_depth", action="store_true")
    parser.add_argument("--use_expcomp", action="store_true")
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--aa", action="store_true")
    parser.add_argument("--mipnerf360", "-m360", default="")
    parser.add_argument("--tanksandtemples", "-tat", default="")
    parser.add_argument("--deepblending", "-db", default="")
    args = parser.parse_args(argv)

    groups = []
    if args.mipnerf360:
        groups += [("m360", s, args.mipnerf360,
                    " -i images_4" if s in mipnerf360_outdoor_scenes
                    else " -i images_2")
                   for s in mipnerf360_outdoor_scenes
                   + mipnerf360_indoor_scenes]
    if args.tanksandtemples:
        groups += [("tat", s, args.tanksandtemples, "")
                   for s in tanks_and_temples_scenes]
    if args.deepblending:
        groups += [("db", s, args.deepblending, "")
                   for s in deep_blending_scenes]

    extra = " --quiet --eval --test_iterations -1"
    if args.use_depth:
        extra += " -d depths"
    if args.use_expcomp:
        extra += " --exposure_lr_init 0.001 --exposure_lr_final 0.0001 " \
                 "--exposure_lr_delay_steps 5000 " \
                 "--exposure_lr_delay_mult 0.001 --train_test_exp"
    if args.fast:
        extra += " --optimizer_type sparse_adam"
    if args.aa:
        extra += " --antialiasing"

    timings = {}
    if not args.skip_training:
        for tag, scene, base, img_flag in groups:
            src = os.path.join(base, scene)
            out = os.path.join(args.output_path, scene)
            t0 = time.time()
            run(f"{entry('train')} -s {src}{img_flag} -m {out}{extra}")
            timings.setdefault(tag, 0.0)
            timings[tag] += (time.time() - t0) / 60.0
        with open(os.path.join(args.output_path, "timing.txt"), "w") as f:
            for tag, minutes in timings.items():
                f.write(f"{tag}: {minutes} minutes\n")

    if not args.skip_rendering:
        for tag, scene, base, img_flag in groups:
            src = os.path.join(base, scene)
            out = os.path.join(args.output_path, scene)
            for it in (7000, 30000):
                run(f"{entry('render')} --iteration {it} "
                    f"-s {src} -m {out} --eval --skip_train")

    if not args.skip_metrics:
        from .eval.metrics import have_lpips  # noqa: PLC0415
        if not have_lpips():
            print("WARNING: LPIPS weights unavailable (set "
                  "PDGS_LPIPS_WEIGHTS; see scripts/export_lpips_weights.py)"
                  " — suite results will omit the LPIPS column.",
                  flush=True)
        paths = " ".join(os.path.join(args.output_path, scene)
                         for _, scene, _, _ in groups)
        run(f"{entry('metrics')} -m {paths}")


if __name__ == "__main__":
    main(sys.argv[1:])
