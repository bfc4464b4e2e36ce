"""What the benchmark loads: never JAX nor the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference and the counts nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "priordepth_gaussiansplatting_tpu"}
PORT = "priordepth_gaussiansplatting_torch"

LOAD_ALL = """
import json, sys
import benchmark.run, benchmark.control, benchmark.trace
from benchmark import drivers, harness
for p in sorted((harness.ROOT / "configs").glob("*.json")):
    harness.load_json("configs", p.stem)
for p in sorted((harness.ROOT / "traffic").glob("*.json")):
    drivers.load(harness.load_json("traffic", p.stem)["driver"])
for kind in ("end_to_end", "layer_metrics"):
    for p in sorted((harness.ROOT / kind).glob("*.py")):
        harness.reader(kind, p.stem)
drivers._port()
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_YARDSTICK = """
import json, sys
import benchmark.counts, benchmark.reference.render, benchmark.reference.train
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _top_level(LOAD_ALL)
    assert PORT in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_and_counts_load_nothing_of_the_port():
    names = _top_level(LOAD_YARDSTICK)
    assert PORT not in names
    assert not names & FORBIDDEN


@pytest.mark.parametrize("loaded, bad", [
    (["priordepth_gaussiansplatting_torch.ops"], set()),
    (["priordepth_gaussiansplatting_tpu.ops"], {"priordepth_gaussiansplatting_tpu"}),
    (["jax._src.core", "numpy"], {"jax"}),
    (["jaxtyping"], set()),
])
def test_names_are_compared_whole(loaded, bad, monkeypatch):
    from benchmark import run
    monkeypatch.setattr(sys, "modules", {m: None for m in loaded})
    assert set(run.forbidden_modules()) == bad
