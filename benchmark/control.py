"""The readings that a cell's limits are set from, in one process on the
card (the benchmark's own runs do not run this):

  * the program's: each compared number of a short run, on each of
    `--program-seeds`;
  * the driver's controls (``Driver.controls``), on each of
    `--control-seeds`: the reference put in the program's place and
    computed in bfloat16, the precision below the configuration's
    float32, and the faults the driver plants, each judged by the float32
    reference;
  * the scene's counted work on a few views of the first control seed.

    python3 -m benchmark.control --workload <cell> [--config <config>
        --traffic <mix>] --program-seeds a,b,.. --control-seeds c,d,e
        --seconds 3 --out <file.json>

A cell that ``BENCHMARK.json`` does not list (yet) is named by
`--config` and `--traffic`; its limits are read from
``benchmark/limits/<cell>.json`` all the same.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import counts, drivers, harness


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program_readings(spec, wl, seeds, seconds):
    out = []
    for seed in seeds:
        r = harness.run_cell(spec, wl, seed, seconds, False,
                             time.perf_counter())
        out.append({"seed": seed, "attempted": r["attempted"],
                    "failed": r["failed"], "correct": r["correct"],
                    "numbers": {k: v["value"] for k, v in r["checked"].items()},
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()}})
        harness.log(f"program seed {seed}: {out[-1]['numbers']}")
        _free()
    return out


def control_readings(wl, seeds, views: int = 3):
    cfg = harness.load_json("configs", wl["config"])
    mix = harness.load_json("traffic", wl["traffic"])
    out = []
    for i, seed in enumerate(seeds):
        drv = drivers.load(mix["driver"])(cfg, mix, seed, "cuda")
        drv.setup()
        drv.release()
        _free()
        row = {"seed": seed, **drv.controls()}
        if i == 0:
            params = drv.store_params()
            row["stats"] = [counts.view_stats(params, drv.view(v),
                                              cfg["sh_degree"])
                            for v in drv.test_idx[:views]]
        harness.log(f"control seed {seed}: {row}")
        out.append(row)
        del drv
        _free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    wl = next((w for w in spec["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        if not (args.config and args.traffic):
            print(f"{args.workload!r} is not in BENCHMARK.json: name its "
                  "--config and --traffic", file=sys.stderr)
            return 2
        wl = {"name": args.workload, "config": args.config,
              "traffic": args.traffic, "chips": 1}

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    result = {"workload": args.workload,
              "card": harness.card(),
              "program": program_readings(spec, wl,
                                          seeds(args.program_seeds),
                                          args.seconds),
              "control": control_readings(wl, seeds(args.control_seeds))}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
