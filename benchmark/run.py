"""Run one cell of the benchmark of ``priordepth_gaussiansplatting_torch``:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device; with --trace 1 also
breakdown), its last key ``checked``: each number compared with its limit,
also printed as the last lines of standard error. Without a CUDA card the
run fails; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Process start, for setup_s: from the kernel's record of this process
# where it can be read, else the first line Python runs.
T0_WALL = time.time()
T0 = time.perf_counter()


def _process_start() -> float:
    """The process's start on the perf_counter clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        started = boot + start_ticks / os.sysconf("SC_CLK_TCK")
        return T0 - max(0.0, T0_WALL - started)
    except (OSError, ValueError, IndexError, StopIteration):
        return T0


FORBIDDEN = ("jax", "jaxlib", "flax", "priordepth_gaussiansplatting_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = _process_start()

    import torch

    from . import harness

    spec = harness.load_spec()
    wl = next((w for w in spec["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"unknown workload {args.workload!r}; cells: "
              f"{[w['name'] for w in spec['workloads']]}", file=sys.stderr)
        return 2
    chips = wl["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " — the benchmark does not run on the CPU", file=sys.stderr)
        return 2
    out = harness.run_cell(spec, wl, args.seed, args.seconds,
                           bool(args.trace), t0)
    leaked = forbidden_modules()
    if leaked:
        print(f"the run loaded {leaked}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    harness.log(f"run {time.perf_counter() - t0:.1f} s")
    for name, c in out["checked"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
