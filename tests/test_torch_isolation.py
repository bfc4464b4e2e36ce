"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points run on the card or raise unless the caller asks for the
CPU."""

import ast
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


CHAIN_MODULES = ("convert", "train_image", "train_video", "SIBR_viewer",
                 "make_synthetic_scene", "data.native", "utils.shell",
                 "utils.standins")


def test_the_chain_modules_are_among_those_imported():
    """test_importing_port_loads_no_jax imports every port module, the
    chain CLIs, the native reader and the scene generator among them."""
    assert {f"priordepth_gaussiansplatting_torch.{m}"
            for m in CHAIN_MODULES} <= set(port_modules())


# What the port and chip_smoke.py must not run or load: the repo's scene
# tool and the root scripts of the JAX package, named as files.
ROOT_SCRIPTS = ("train", "render", "metrics", "full_eval", "convert",
                "train_image", "train_video", "SIBR_viewer", "bench")
SCRIPT_PATH = re.compile(
    r"(?:^|[\s/\"'])(?:(?:tools/)?make_synthetic_scene|"
    + "|".join(ROOT_SCRIPTS) + r")\.py(?:$|[\s\"'])")


def script_paths(src: str) -> list:
    """(line, text) of each string in `src`, docstrings aside, that names
    the scene tool or a root script as a file: a path or a command line
    (f-strings' literal parts included)."""
    tree = ast.parse(src)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs and SCRIPT_PATH.search(node.value)]


@pytest.mark.parametrize("snippet", [
    'run_cmd([sys.executable, "tools/make_synthetic_scene.py", s, "8"])',
    'os.path.join(REPO, "tools", "make_synthetic_scene.py")',
    'os.system(f"{sys.executable} convert.py -s {src}")',
    'os.system(f"{py} train.py -s {src}{flags}")',
    'subprocess.run([sys.executable, "SIBR_viewer.py", "-m", m])',
    'runpy.run_path(os.path.join(REPO, "bench.py"))',
])
def test_the_script_scan_sees_a_script_run_or_loaded(snippet):
    assert script_paths(snippet), snippet


def test_no_port_source_runs_or_loads_a_jax_script():
    """Neither chip_smoke.py nor a port module starts or loads the repo's
    ``tools/make_synthetic_scene.py`` or a root JAX script: the port runs
    its own modules (``python -m priordepth_gaussiansplatting_torch.*``)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PORT_DIR):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    for path in paths:
        with open(path) as f:
            assert not script_paths(f.read()), path


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


def _depth_model():
    from priordepth_gaussiansplatting_torch.depth import config
    config.build_model(config.get_config(embed_dim=64, encoder_depth=1))


def _depth_priors(tmp_path):
    from priordepth_gaussiansplatting_torch.depth import infer, layers, model
    vit = layers.build(model.ViTEncoder, embed_dim=64, depth=1,
                       device="cpu")
    infer.generate_depth_priors(vit, str(tmp_path), str(tmp_path / "d"))


def _depth_trainer():
    from priordepth_gaussiansplatting_torch.depth import layers, model, trainer
    vit = layers.build(model.ViTEncoder, embed_dim=64, depth=1,
                       device="cpu")
    trainer.DepthTrainer(vit, trainer.DepthTrainerConfig())


def _depth_train_proof(tmp_path):
    from priordepth_gaussiansplatting_torch import depth_train_proof
    depth_train_proof.main(["2", "32", "2", "--out_dir", str(tmp_path)])


def _viewer():
    from priordepth_gaussiansplatting_torch.viewer import network_gui
    network_gui.NetworkGUI("127.0.0.1", 0)


@pytest.mark.parametrize("entry", ["resolve_device", "look_at_camera",
                                   "load_model_snapshot", "render_cli",
                                   "interop", "create_from_points",
                                   "adam_state_from_numpy",
                                   "initialize_multihost", "train_cli",
                                   "perf_probe", "trainer",
                                   "load_checkpoint", "densify_probe",
                                   "metrics_cli", "feature_table",
                                   "depth_model", "depth_priors", "viewer",
                                   "depth_trainer", "depth_train_proof"])
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
        "metrics_cli": lambda: _metrics_cli(tmp_path),
        "feature_table": _feature_table,
        "depth_model": _depth_model,
        "depth_priors": lambda: _depth_priors(tmp_path),
        "viewer": _viewer,
        "depth_trainer": _depth_trainer,
        "depth_train_proof": lambda: _depth_train_proof(tmp_path),
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
