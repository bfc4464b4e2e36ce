"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points run on the card or raise unless the caller asks for the
CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import priordepth_gaussiansplatting_torch as port

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)
FORBIDDEN = r"(jax|jaxlib|flax|optax|priordepth_gaussiansplatting_tpu)\b"


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PORT_DIR], prefix="priordepth_gaussiansplatting_torch."))


def test_importing_port_loads_no_jax():
    """In a fresh interpreter (the test process has jax loaded already)."""
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', "
        "'priordepth_gaussiansplatting_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_sources_import_no_jax():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PORT_DIR):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    pattern = re.compile(
        rf"^\s*(import|from)\s+{FORBIDDEN}"
        rf"|import_module\(\s*['\"]{FORBIDDEN}"
        rf"|__import__\(\s*['\"]{FORBIDDEN}", re.M)
    assert len(paths) > 20
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not pattern.search(src), path


def _look_at():
    from priordepth_gaussiansplatting_torch.utils import testing
    testing.look_at_camera((0, 0, -2.5), width=32, height=32)


def _load_snapshot(tmp_path):
    from priordepth_gaussiansplatting_torch.train import checkpoint
    checkpoint.load_model_snapshot(str(tmp_path))


def _render_cli(tmp_path):
    from priordepth_gaussiansplatting_torch import render
    render.main(["-m", str(tmp_path)])


def _interop():
    from priordepth_gaussiansplatting_torch import interop
    interop.camera_from_numpy(torch.eye(4).numpy(), torch.eye(4).numpy(),
                              [0, 0, 0], 8, 8, 1.0, 1.0)


def _create_from_points():
    from priordepth_gaussiansplatting_torch.models import gaussians
    gaussians.create_from_points(torch.rand(8, 3).numpy(),
                                 torch.rand(8, 3).numpy(), num_images=1)


def _initialize_multihost(tmp_path):
    from priordepth_gaussiansplatting_torch.parallel import mesh
    mesh.initialize_multihost(f"file://{tmp_path}/store", 1, 0)


def _adam_state():
    from priordepth_gaussiansplatting_torch import interop
    zeros = {k: torch.zeros(2).numpy() for k in interop.PARAM_FIELDS}
    interop.adam_state_from_numpy(zeros, zeros, 0)


def _train_cli(tmp_path):
    from priordepth_gaussiansplatting_torch.train import __main__ as cli
    cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m")])


def _perf_probe():
    from priordepth_gaussiansplatting_torch import perf_probe
    perf_probe.main(["64", "32", "32"])


def _densify_probe(tmp_path):
    from priordepth_gaussiansplatting_torch import densify_probe
    densify_probe.main([str(tmp_path / "chkpnt1.pkl"), "-s", str(tmp_path)])


def _bench():
    from priordepth_gaussiansplatting_torch import bench
    bench.run(64, 32, 32, 1, None)


def _trainer():
    from priordepth_gaussiansplatting_torch.train import trainer
    from priordepth_gaussiansplatting_torch.utils import config
    trainer.Trainer(config.ModelConfig(), config.OptimizationConfig(),
                    config.PipelineConfig(), scene=None)


def _load_checkpoint(tmp_path):
    from priordepth_gaussiansplatting_torch.train import checkpoint
    checkpoint.load_checkpoint(str(tmp_path / "chkpnt1.pkl"))


def _metrics_cli(tmp_path):
    from priordepth_gaussiansplatting_torch import metrics
    metrics.main(["-m", str(tmp_path)])


def _feature_table():
    from priordepth_gaussiansplatting_torch.train import prune
    prune.FeatureTable.empty(8)


@pytest.mark.parametrize("entry", ["resolve_device", "look_at_camera",
                                   "load_model_snapshot", "render_cli",
                                   "interop", "create_from_points",
                                   "adam_state_from_numpy",
                                   "initialize_multihost", "train_cli",
                                   "perf_probe", "trainer",
                                   "load_checkpoint", "densify_probe",
                                   "bench", "metrics_cli", "feature_table"])
def test_entry_points_need_the_card_or_cpu(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    calls = {
        "resolve_device": port.resolve_device,
        "look_at_camera": _look_at,
        "load_model_snapshot": lambda: _load_snapshot(tmp_path),
        "render_cli": lambda: _render_cli(tmp_path),
        "interop": _interop,
        "create_from_points": _create_from_points,
        "adam_state_from_numpy": _adam_state,
        "initialize_multihost": lambda: _initialize_multihost(tmp_path),
        "train_cli": lambda: _train_cli(tmp_path),
        "perf_probe": _perf_probe,
        "trainer": _trainer,
        "load_checkpoint": lambda: _load_checkpoint(tmp_path),
        "densify_probe": lambda: _densify_probe(tmp_path),
        "bench": _bench,
        "metrics_cli": lambda: _metrics_cli(tmp_path),
        "feature_table": _feature_table,
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert port.resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_fallback_on_mixed_devices():
    """A wrapper picks its plain version only because its tensors lie on
    the CPU; the device check rejects anything else."""
    from priordepth_gaussiansplatting_torch import kernels
    with pytest.raises(ValueError, match="CUDA"):
        kernels.check_cuda("expand_pairs", a=torch.zeros(2))
