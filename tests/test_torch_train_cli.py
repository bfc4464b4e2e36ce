"""The port's train CLI (``python -m priordepth_gaussiansplatting_torch.
train``) and its stage probe (``python -m priordepth_gaussiansplatting_
torch.perf_probe``) on the CPU: a 20-iteration run through the tile
pipeline's plain versions with its artifacts, a resume from its checkpoint,
the refusal of what is not ported yet (the thesis events at their default
iterations) and of multi-rank grids that cannot run."""

import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys

import pytest
import torch

from priordepth_gaussiansplatting_torch import perf_probe
from priordepth_gaussiansplatting_torch.data import dataset
from priordepth_gaussiansplatting_torch.train import __main__ as train_cli
from priordepth_gaussiansplatting_torch.train import trainer
from priordepth_gaussiansplatting_torch.utils import config
from test_torch_trainer import make_scene

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_EVENTS = ["--noise_injection_iter", "0", "--floating_prune_iter", "0"]
OPT_NO_EVENTS = dict(noise_injection_iter=0, floating_prune_iter=0)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_scene(str(tmp_path_factory.mktemp("scene")), views=4)


def events(model):
    with open(os.path.join(model, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_artifacts_and_resume(scene_dir, tmp_path, capsys):
    model = str(tmp_path / "model")
    common = ["-s", scene_dir, "--data_device", "cpu", "--eval",
              "--backend", "kernels", "--disable_viewer", "--quiet"]
    result = train_cli.main(common + NO_EVENTS + [
        "-m", model, "--iterations", "20", "--test_iterations", "10", "20",
        "--save_iterations", "20", "--checkpoint_iterations", "10"])
    assert result["iterations_run"] == 20 and result["skipped"] == 0
    # on the CPU the wrappers take their plain versions: no launches
    assert result["step_launches"] == {}
    for rel in ("cfg_args", "events.jsonl", "exposure.json", "chkpnt10.pkl",
                "cameras.json", "input.ply",
                "point_cloud/iteration_20/point_cloud.ply"):
        assert os.path.exists(os.path.join(model, rel)), rel
    with open(os.path.join(model, "cfg_args")) as f:
        assert f.read().startswith("Namespace(")
    ev = events(model)
    psnr = {e["step"]: e["value"] for e in ev
            if e.get("tag") == "test/loss_viewpoint - psnr"}
    assert set(psnr) == {10, 20}
    losses = [e for e in ev if e.get("tag") == "train_loss_patches/l1_loss"]
    assert [e["step"] for e in losses] == [10, 20]
    assert any("image" in e for e in ev)
    with open(os.path.join(model, "exposure.json")) as f:
        assert len(json.load(f)) == 3  # one per training view
    with open(os.path.join(model, "chkpnt10.pkl"), "rb") as f:
        assert pickle.load(f)["iteration"] == 10
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("Training complete: {")

    resumed = str(tmp_path / "resumed")
    result = train_cli.main(common + NO_EVENTS + [
        "-m", resumed, "--iterations", "20", "--test_iterations", "20",
        "--save_iterations", "20",
        "--start_checkpoint", os.path.join(model, "chkpnt10.pkl")])
    assert result["iterations_run"] == 10 and result["skipped"] == 0
    assert "Restored checkpoint at iteration 10" in capsys.readouterr().out
    assert os.path.exists(os.path.join(
        resumed, "point_cloud/iteration_20/point_cloud.ply"))
    assert {e["step"] for e in events(resumed) if "value" in e} == {20}


def test_report_renders_every_pair(scene_dir, monkeypatch, capsys):
    """The report renders each view at the store's default pair capacity,
    as the JAX trainer's does, whatever rung the training ladder is on:
    every pair of this scene fits, so the PSNR equals the dense oracle's.
    A view that overflows that capacity is reported."""
    from priordepth_gaussiansplatting_torch.ops import rasterize
    psnr, tr = {}, {}
    for backend in ("kernels", "oracle"):
        tr[backend] = trainer.Trainer(
            config.ModelConfig(source_path=scene_dir, eval=True),
            config.OptimizationConfig(), config.PipelineConfig(
                backend=backend),
            dataset.Scene(scene_dir, eval_split=True, device="cpu"),
            quiet=False, device="cpu")
        tr[backend].pair_capacity = 64  # far below the pairs of a view
        psnr[backend] = tr[backend].report(1)["test"]["psnr"]
    assert abs(psnr["kernels"] - psnr["oracle"]) <= 1e-3, psnr
    assert "overflowed" not in capsys.readouterr().out
    monkeypatch.setattr(rasterize, "default_pair_capacity", lambda n: 64)
    low = tr["kernels"].report(2)["test"]["psnr"]
    assert "overflowed the pair capacity" in capsys.readouterr().out
    assert low < psnr["oracle"] - 0.5, (low, psnr)


def test_step_launches_leave_out_the_reports(scene_dir, monkeypatch):
    """The run's summary counts the launches of its steps only: a launch
    counted in every step and in every evaluation render shows once per
    step."""
    from priordepth_gaussiansplatting_torch import kernels
    from priordepth_gaussiansplatting_torch.train import step as step_lib

    def counted(fn):
        def wrapped(*args, **kw):
            kernels._launches["expand_pairs"] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(step_lib, "eval_image", counted(step_lib.eval_image))
    tr = trainer.Trainer(
        config.ModelConfig(source_path=scene_dir, eval=True),
        config.OptimizationConfig(**OPT_NO_EVENTS),
        config.PipelineConfig(backend="kernels"),
        dataset.Scene(scene_dir, eval_split=True, device="cpu"),
        quiet=True, device="cpu")
    tr.fns = dataclasses.replace(tr.fns, step=counted(tr.fns.step))
    result = tr.train(iterations=6, test_iterations=(3, 6),
                      save_iterations=())
    assert result["step_launches"] == {"expand_pairs": 6}, result


def test_train_cli_refuses_the_default_thesis_events(scene_dir, tmp_path):
    """30,000 iterations reach the noise injection at its default 30,000:
    the run raises before its first step instead of skipping it."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: Prune"):
        train_cli.main(["-s", scene_dir, "-m", str(tmp_path / "m"),
                        "--data_device", "cpu", "--disable_viewer",
                        "--quiet"])
    assert not os.path.exists(tmp_path / "m" / "chkpnt30000.pkl")


# Multi-rank runs the CLI refuses: a process group of another size than
# n_data x n_gauss, more ranks than the machine has cards, an empty grid.
REFUSALS = [
    dict(argv=["--n_gauss", "2", "--data_device", "cpu"],
         env={"WORLD_SIZE": "3", "RANK": "0", "MASTER_ADDR": "localhost"},
         match="WORLD_SIZE 3 is not --n_data 1 x --n_gauss 2"),
    dict(argv=["--n_data", "2"], env={}, cards=1,
         match="needs 2 cards, one per rank; this machine has 1"),
    dict(argv=["--tile_shard", "--n_gauss", "0", "--data_device", "cpu"],
         env={}, match="must be at least 1"),
]


@pytest.mark.parametrize("flags", REFUSALS)
def test_train_cli_refuses_multi_rank(flags, tmp_path, monkeypatch):
    for var in train_cli.GROUP_ENV:
        monkeypatch.delenv(var, raising=False)
    for var, value in flags["env"].items():
        monkeypatch.setenv(var, value)
    if "cards" in flags:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count",
                            lambda: flags["cards"])
    with pytest.raises(ValueError, match=flags["match"]):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m")]
                       + flags["argv"])
    assert not os.path.exists(tmp_path / "m")


def test_train_cli_module_entry_point(tmp_path):
    """``python -m`` reaches the same main (and fails as it should)."""
    env = {k: v for k, v in os.environ.items()
           if k not in train_cli.GROUP_ENV}
    out = subprocess.run(
        [sys.executable, "-m", "priordepth_gaussiansplatting_torch.train",
         "-s", str(tmp_path), "--data_device", "cpu", "--n_gauss", "2"],
        cwd=REPO, env=dict(env, PYTHONPATH=REPO, **REFUSALS[0]["env"]),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "WORLD_SIZE 3 is not --n_data 1 x --n_gauss 2" in out.stderr


def test_densify_probe_on_the_cpu(scene_dir, tmp_path, capsys):
    """The densify probe on a checkpoint of the CLI, with the run's flags:
    its ``full`` round makes the trainer's own round (the same counts and
    parameters), and every variant reports PSNR."""
    from priordepth_gaussiansplatting_torch import densify_probe
    from priordepth_gaussiansplatting_torch.train import checkpoint
    flags = ["-s", scene_dir, "--data_device", "cpu", "--eval",
             "--backend", "kernels", "--disable_viewer", "--quiet",
             "--densify_from_iter", "2", "--densification_interval", "3",
             "--opacity_reset_interval", "4",
             "--densify_grad_threshold", "5e-5"] + NO_EVENTS
    model = str(tmp_path / "model")
    train_cli.main(flags + ["-m", model, "--iterations", "6",
                            "--test_iterations", "6", "--save_iterations",
                            "6", "--checkpoint_iterations", "5"])
    rows = densify_probe.main(
        [os.path.join(model, "chkpnt5.pkl")] + flags)
    inputs = rows[0]["round_inputs"]
    assert rows[0]["iteration"] == 5 and inputs["use_size_threshold"]
    by = {r["variant"]: r for r in rows[1:]}
    assert set(by) == {"before", "full", "prune_only", "clone_only",
                       "split_only", "prune_opacity_only"}
    assert all(math.isfinite(r["psnr"]["test"]["psnr"]) for r in rows[1:])
    assert by["prune_only"]["counts"]["n_pruned"] == (
        inputs["n_prune_opacity"] + inputs["n_prune_size"]
        - inputs["n_prune_size_and_opacity"])
    assert by["prune_opacity_only"]["counts"]["n_pruned"] == (
        inputs["n_prune_opacity"])
    full = by["full"]["counts"]
    assert full["n_cloned"] + full["n_split"] > 0
    assert (by["clone_only"]["counts"]["n_cloned"]
            == by["split_only"]["counts"]["n_split"]
            == full["n_cloned"] + full["n_split"])

    # The trainer's own round at iteration 6, from the same checkpoint.
    tr = train_cli.build_trainer(train_cli.parser().parse_args(
        flags + ["--iterations", "6"]))
    tr.restore(os.path.join(model, "chkpnt5.pkl"))
    tr.generator = torch.Generator("cpu").manual_seed(0)
    _, _, info = tr.fns.densify(tr.state, tr.opt_state,
                                use_size_threshold=True,
                                generator=tr.generator)
    assert {k: int(v) for k, v in info.items()} == full
    capsys.readouterr()


def test_perf_probe_on_the_cpu(capsys):
    res = perf_probe.main(["300", "48", "32", "--device", "cpu"])
    assert set(res["stages"]) == {"project", "bin+sort", "full fwd",
                                  "full fwd+bwd"}
    assert res["pairs"] > 0 and res["overflow"] == 0
    assert res["pair_capacity"] % 1024 == 0
    assert all(st["calls"] == 11 and st["launches"] == {}
               for st in res["stages"].values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == json.dumps(res)
    assert any(line.startswith("pairs=") for line in lines)
    assert any(line.startswith("rays/s fwd+bwd") for line in lines)
