"""One run of one cell: set-up, the measured window (or the traced span),
the program's state freed, the reference's check, and the metrics read by
their readers. Everything of one configuration, mix, cell or metric sits
in a file of its own, found by its name in ``BENCHMARK.json``:

  benchmark/configs/<config>.json       sizes, settings, what was assumed
  benchmark/traffic/<mix>.json          the mix's parameters; its "driver"
                                        names a kind of traffic
  benchmark/drivers/<kind>.py           that kind's driver: its window, its
                                        span and the check of its outputs
  benchmark/limits/<workload>.json      each compared number's limit
  benchmark/end_to_end/<metric>.py      read(r) -> value or None
  benchmark/layer_metrics/<metric>.py   read(r) -> value or None
  benchmark/counts/                     operations and bytes, the peaks
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import drivers

ROOT = Path(__file__).resolve().parent
SPEC = ROOT.parent / "BENCHMARK.json"


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def load_spec(path: Path = SPEC) -> dict:
    return json.loads(Path(path).read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def reader(kind: str, name: str):
    """The `read` function of metric `name` (a file named after it)."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, workload: str, section: str) -> list:
    """The metrics of `section` this cell reports."""
    return [m for m in spec[section]
            if "workloads" not in m or workload in m["workloads"]]


class Reading:
    """What a metric's reader is given: the driver's window or span, the
    set-up time, the trace, and the counted stats of the span's views."""

    def __init__(self, drv, setup_s: float, span):
        self.kind = drv.kind
        self.units = drv.units
        self.window_s = drv.window_s
        self.latencies = drv.latencies
        self.setup_s = setup_s
        self.span = span
        self.cfg = drv.cfg
        self._drv = drv
        self._stats = None

    def stats(self) -> list:
        """(stats, times) of each distinct view of the traced span: the
        quantities ``benchmark/counts`` turns into operations and bytes
        (made on first use)."""
        if self._stats is None:
            with torch.no_grad():
                self._stats = [tuple(v) for v in
                               self._drv.span_stats().values()]
        return self._stats

    def total(self, per_view) -> float:
        """`per_view(stats)` summed over the traced span's units."""
        return sum(times * per_view(s) for s, times in self.stats())


def card() -> dict:
    """The card's name and count, and its power limit from the
    ``nvidia-smi`` row of the same card: by UUID, else by PCI bus id (so
    that CUDA_VISIBLE_DEVICES cannot pick another row), else the only row."""
    props = torch.cuda.get_device_properties(0)
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    try:
        rows = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,pci.bus_id,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        rows = []
    row = smi_row(rows, str(getattr(props, "uuid", "")),
                  "%02X:%02X.0" % (getattr(props, "pci_bus_id", 0),
                                   getattr(props, "pci_device_id", 0)))
    if row is not None:
        try:
            out["power_limit_w"] = float(row[2])
        except ValueError:
            pass
    return out


def smi_row(rows: list, uuid: str, bus: str):
    """The (uuid, bus id, power limit) fields of the row that names this
    card, or None."""
    fields = [[f.strip() for f in r.split(",")] for r in rows]
    fields = [f for f in fields if len(f) == 3]
    for f in fields:
        if uuid and f[0].lower().endswith(uuid.lower()):
            return f
    for f in fields:
        if f[1].upper().endswith(bus):
            return f
    return fields[0] if len(fields) == 1 else None


def run_cell(spec: dict, wl: dict, seed: int, seconds: float, trace: bool,
             t0: float, device="cuda", cfg=None, mix=None,
             limits=None) -> dict:
    """One run of the cell `wl` (an entry of ``workloads``, found by name or
    given whole). `cfg`, `mix` and `limits` replace the files' (the CPU
    tests run the same path at a tiny size)."""
    cfg = cfg or load_json("configs", wl["config"])
    mix = mix or load_json("traffic", wl["traffic"])
    if limits is None:
        path = ROOT / "limits" / f"{wl['name']}.json"
        limits = json.loads(path.read_text()) if path.exists() else {}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv = drivers.load(mix["driver"])(cfg, mix, seed, device)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.2f} s")
    span = None
    if trace:
        from .trace import traced
        got = {}
        t_span = time.perf_counter()
        drv.span(traced(got))
        span = got["span"]
        log(f"span of {span.wall_s:.3f} s traced and reduced in "
            f"{time.perf_counter() - t_span:.2f} s")
    else:
        drv.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    log(f"window {drv.units} units in {drv.window_s:.3f} s, "
        f"peak {peak / 2 ** 30:.2f} GiB")
    reading = Reading(drv, setup_s, span)
    t_check = time.perf_counter()
    numbers = drv.check()
    log(f"check {time.perf_counter() - t_check:.2f} s")
    checked = {k: {"value": v, "limit": limits.get(k, {}).get("limit")}
               for k, v in numbers.items()}
    correct = bool(checked) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checked.values())
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    t_read = time.perf_counter()
    for m in cell_metrics(spec, wl["name"], section):
        value = reader("layer_metrics" if trace else "end_to_end",
                       m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"metrics read in {time.perf_counter() - t_read:.2f} s")
    dev = card() if cuda else {"platform": "cpu", "kind": "cpu", "count": 0}
    dev["memory_peak_bytes"] = peak
    out = {"correct": correct, "attempted": drv.units, "failed": drv.failed,
           "metrics": metrics, "device": dev}
    if span is not None:
        dev["busy_s"] = span.busy_s
        dev["window_s"] = span.wall_s
        out["breakdown"] = {"device_ops": span.top_ops(),
                            "idle_gaps": span.gaps}
    out["checked"] = checked
    return out
