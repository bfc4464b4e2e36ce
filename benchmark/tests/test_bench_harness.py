"""BENCHMARK.json against the contract the harness keeps, every cell loaded
by name, a run without a card, and the result line of a tiny CPU run."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import drivers, harness
from benchmark.tests.conftest import SEED, TRAIN_CELLS, tiny_config, tiny_mix

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
BENCH = ROOT / "benchmark"


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]] + WORKLOADS
             + [m["name"] for m in _metrics()])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in _metrics():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}


def _cell_files(wl):
    """The files a cell is found by, loaded: configuration, mix and its
    driver, limits."""
    cfg = harness.load_json("configs", wl["config"])
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    mix = harness.load_json("traffic", wl["traffic"])
    assert callable(drivers.load(mix["driver"]))
    limits = harness.load_json("limits", wl["name"])
    for k, v in limits.items():
        assert v["lower"] < v["limit"], (k, v)
        if v.get("upper") is not None:
            assert v["limit"] < v["upper"], (k, v)
    return cfg, mix, limits


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_loads_by_name(workload):
    wl = next(w for w in SPEC["workloads"] if w["name"] == workload)
    assert wl["chips"] == 1 and 1 <= len(wl["why"]) <= 200
    conf = next(c for c in SPEC["configs"] if c["name"] == wl["config"])
    assert conf["file"] == f"benchmark/configs/{wl['config']}.json"
    assert conf["reduced"] == []
    _, _, limits = _cell_files(wl)
    assert set(limits) == {"image_gap_p9999"}
    e2e = harness.cell_metrics(SPEC, workload, "end_to_end")
    layer = harness.cell_metrics(SPEC, workload, "per_layer")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in e2e:
        assert callable(harness.reader("end_to_end", m["name"]))
    for m in layer:
        assert callable(harness.reader("layer_metrics", m["name"]))
        # Each per-layer metric's cells report what it moves.
        assert m["moves"] in {e["name"] for e in e2e}, (workload, m)


@pytest.mark.parametrize("wl", TRAIN_CELLS, ids=lambda w: w["name"])
def test_the_held_out_training_cells_files_load(wl):
    _, mix, limits = _cell_files(wl)
    assert mix["driver"] == "train"
    assert set(limits) == {"loss_gap", "grad_gap", "change_gap",
                           "stats_gap"}
    for f in ("end_to_end/train_it_s.py", "layer_metrics/k3_roofline.train.py",
              "layer_metrics/train_step_mfu.train.py"):
        assert (BENCH / f).exists(), f


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert "bound" not in m and "\n" not in m["layer"]
    # Every metric BENCHMARK.json lists is reported by one of its cells.
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS), m


def test_a_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", WORKLOADS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_result_line_of_a_tiny_run(workload, trace):
    wl = next(w for w in SPEC["workloads"] if w["name"] == workload)
    out = harness.run_cell(SPEC, wl, SEED, 0.5, trace, 0.0, device="cpu",
                           cfg=tiny_config(wl["config"]),
                           mix=tiny_mix(wl["traffic"]))
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checked"
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    section = "per_layer" if trace else "end_to_end"
    listed = {m["name"] for m in harness.cell_metrics(SPEC, workload,
                                                      section)}
    if trace:
        assert "breakdown" in out and "window_s" in out["device"]
        # No device trace on the CPU: the device's readers find nothing.
        assert set(out["metrics"]) <= listed
    else:
        assert set(out["metrics"]) == listed


@pytest.mark.parametrize("rows, uuid, bus, want", [
    (["GPU-aa, 00000000:18:00.0, 700.00", "GPU-bb, 00000000:2A:00.0, 500.00"],
     "", "2A:00.0", "500.00"),
    (["GPU-aa, [N/A], 700.00", "GPU-bb, [N/A], 500.00"], "bb", "2A:00.0",
     "500.00"),
    (["GPU-aa, [N/A], 700.00"], "", "18:00.0", "700.00"),
    (["GPU-aa, [N/A], 700.00", "GPU-bb, [N/A], 500.00"], "", "18:00.0", None),
])
def test_the_card_row_is_matched_by_uuid_or_bus(rows, uuid, bus, want):
    row = harness.smi_row(rows, uuid, bus)
    assert (row[2] if row else None) == want
