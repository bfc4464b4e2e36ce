"""Launch a SIBR viewer on a trained model (counterpart of the root
``SIBR_viewer.py``).

    python -m priordepth_gaussiansplatting_torch.SIBR_viewer -m <model>
        [--viewer_path <dir of SIBR_gaussianViewer_app>] [--with_metrics]

The port's PLY snapshots are byte-compatible with the SIBR gaussian viewer.
With ``--with_metrics`` it first runs the port's render and metrics CLIs
(``python -m priordepth_gaussiansplatting_torch.{render,metrics}``, on the
card). It looks for the app as the root script does, and prints the same
message and returns 1 when it is absent. It returns non-zero when a
command it ran failed: the app's exit code, else the first failing
command's (the root script ignores the render's and the metrics' result
and returns the app's wait status).
"""

from __future__ import annotations

import os
import shutil
import sys
from argparse import ArgumentParser

from .utils.shell import entry, system


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--viewer_path", default="",
                        help="dir containing SIBR_gaussianViewer_app")
    parser.add_argument("--with_metrics", action="store_true")
    args = parser.parse_args(argv)

    failed = []
    if args.with_metrics:
        for name in ("render", "metrics"):
            code = system(f"{entry(name)} -m {args.model_path}")
            if code:
                failed.append(code)

    app = None
    for cand in ("SIBR_gaussianViewer_app", "SIBR_gaussianViewer_app.exe"):
        p = os.path.join(args.viewer_path, cand) if args.viewer_path \
            else shutil.which(cand)
        if p and os.path.exists(p):
            app = p
            break
    if app is None:
        print("SIBR viewer binary not found; the model is viewable with any "
              "3DGS PLY viewer at:",
              os.path.join(args.model_path, "point_cloud"))
        return 1
    return system(f'"{app}" -m {args.model_path}') or \
        (failed[0] if failed else 0)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
