"""The port's evaluation on the CPU against the JAX package's: LPIPS
(``eval/metrics.py``) with the same random VGG16 weights written by the
test (.npz and .pth), the metrics CLI against the root ``metrics.py`` on
the same render and ground-truth PNGs, and ``full_eval``'s command lines
against the root ``full_eval.py``'s with ``os.system`` recorded.

Tolerances: LPIPS rtol 1e-4 (convolutions summed in another order);
results.json and per_view.json with equal keys and values within 1e-5 of
max(1, |value|): the JAX package's f32 mean of a 32x32 view's squared
error lands ~1e-6 relative away from the float64 value, 2.4e-5 dB at
21 dB, so the port's PSNR is also held within 1e-5 dB of a float64 PSNR of
the same PNGs; the command lines equal, the port's entry points in place of
the root scripts."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import full_eval as root_full_eval
import metrics as root_metrics
from priordepth_gaussiansplatting_torch import full_eval as pfull_eval
from priordepth_gaussiansplatting_torch import metrics as pmetrics_cli
from priordepth_gaussiansplatting_torch.eval import metrics as pmetrics
from priordepth_gaussiansplatting_tpu.eval import metrics as jmetrics

torch.set_num_threads(2)
VGG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
       512, 512, 512, "M", 512, 512, 512, "M"]


def random_weights(seed: int = 7) -> dict:
    """VGG16-shaped random weights under torchvision's feature indices and
    the LPIPS heads' names."""
    rng = np.random.default_rng(seed)
    arrays, cin, layer = {}, 3, 0
    for item in VGG:
        if item == "M":
            layer += 1
            continue
        arrays[f"features.{layer}.weight"] = (rng.standard_normal(
            (item, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
        arrays[f"features.{layer}.bias"] = (
            0.1 * rng.standard_normal(item)).astype(np.float32)
        cin, layer = item, layer + 2
    for k, c in enumerate((64, 128, 256, 512, 512)):
        arrays[f"lin{k}.model.1.weight"] = (np.abs(rng.standard_normal(
            (1, c, 1, 1))) / c).astype(np.float32)
    return arrays


@pytest.fixture
def weights(tmp_path, monkeypatch):
    """Points PDGS_LPIPS_WEIGHTS at a random .npz; both packages' caches
    are cleared before and after."""
    path = str(tmp_path / "lpips_rand.npz")
    np.savez(path, **random_weights())
    monkeypatch.setenv("PDGS_LPIPS_WEIGHTS", path)
    pmetrics._load_weights.cache_clear()
    jmetrics._load_weights.cache_clear()
    yield path
    pmetrics._load_weights.cache_clear()
    jmetrics._load_weights.cache_clear()


@pytest.fixture
def no_weights(monkeypatch):
    monkeypatch.delenv("PDGS_LPIPS_WEIGHTS", raising=False)
    pmetrics._load_weights.cache_clear()
    jmetrics._load_weights.cache_clear()
    yield
    pmetrics._load_weights.cache_clear()
    jmetrics._load_weights.cache_clear()


def images(seed: int = 0, size: int = 64):
    rng = np.random.default_rng(seed)
    a = rng.random((3, size, size), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal((3, size, size)), 0,
                1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_lpips_matches_jax(weights, fmt, tmp_path, monkeypatch):
    if fmt == "pth":
        path = str(tmp_path / "lpips_rand.pth")
        torch.save({k: torch.tensor(v) for k, v in random_weights().items()},
                   path)
        monkeypatch.setenv("PDGS_LPIPS_WEIGHTS", path)
    a, b = images()
    assert pmetrics.have_lpips() and jmetrics.have_lpips()
    got = pmetrics.compute_lpips(torch.tensor(a), torch.tensor(b))
    want = jmetrics.compute_lpips(a, b)
    assert got == pytest.approx(want, rel=1e-4) and want > 0
    assert pmetrics.compute_lpips(torch.tensor(a), torch.tensor(a)) == \
        pytest.approx(0.0, abs=1e-6)


def test_lpips_without_weights(no_weights, tmp_path, monkeypatch):
    a, b = images()
    assert not pmetrics.have_lpips()
    assert pmetrics.compute_lpips(torch.tensor(a), torch.tensor(b)) == -1.0
    # a file without the five heads counts as no weights
    partial = {k: v for k, v in random_weights().items()
               if not k.startswith("lin4")}
    path = str(tmp_path / "partial.npz")
    np.savez(path, **partial)
    monkeypatch.setenv("PDGS_LPIPS_WEIGHTS", path)
    pmetrics._load_weights.cache_clear()
    assert not pmetrics.have_lpips()
    assert pmetrics.compute_lpips(torch.tensor(a), torch.tensor(b)) == -1.0


def write_model(root, views: int = 3, size: int = 32):
    """<root>/test/ours_<it>/{renders,gt}/*.png for two methods."""
    rng = np.random.default_rng(1)
    for method in ("ours_7", "ours_30"):
        gt = (rng.random((views, size, size, 3)) * 255).astype(np.uint8)
        noise = rng.integers(-40, 40, gt.shape)
        renders = np.clip(gt.astype(int) + noise, 0, 255).astype(np.uint8)
        for sub, arr in (("renders", renders), ("gt", gt)):
            d = os.path.join(root, "test", method, sub)
            os.makedirs(d)
            for i in range(views):
                Image.fromarray(arr[i]).save(os.path.join(d, f"{i:05d}.png"))
    return str(root)


def read(model, name):
    with open(os.path.join(model, name)) as f:
        return json.load(f)


def assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same(got[k], want[k])
    else:
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("lpips", [True, False], ids=["lpips", "no_lpips"])
def test_metrics_cli_matches_root_metrics(lpips, tmp_path, request, capsys):
    request.getfixturevalue("weights" if lpips else "no_weights")
    model = write_model(tmp_path / "model")
    want = root_metrics.evaluate([model])
    want_files = {n: read(model, n) for n in ("results.json",
                                              "per_view.json")}
    want_out = capsys.readouterr().out
    got = pmetrics_cli.main(["-m", model, "--device", "cpu"])
    got_out = capsys.readouterr().out
    assert_same(got, want)
    for name, value in want_files.items():
        assert_same(read(model, name), value)
    assert ("LPIPS" in got[model]["ours_7"]) == lpips
    mdir = os.path.join(model, "test", "ours_7")
    renders, gts, names = root_metrics.read_images(
        os.path.join(mdir, "renders"), os.path.join(mdir, "gt"))
    for r, g, name in zip(renders, gts, names):
        mse = np.mean((r.astype(np.float64) - g) ** 2)
        assert abs(read(model, "per_view.json")["ours_7"]["PSNR"][name]
                   + 10 * np.log10(mse)) <= 1e-5
    # the same lines, the numbers aside
    assert [ln.split(":")[0] for ln in got_out.splitlines()] == \
        [ln.split(":")[0] for ln in want_out.splitlines()]


FLAGS = {
    "all": ["-m360", "/d/m360", "-tat", "/d/tat", "-db", "/d/db",
            "--use_depth", "--use_expcomp", "--fast", "--aa"],
    "tat_only_no_training": ["-tat", "/d/tat", "--skip_training"],
}


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_full_eval_command_lines(case, tmp_path, monkeypatch, no_weights):
    seen = []
    monkeypatch.setattr(os, "system", lambda cmd: seen.append(cmd) or 0)
    argv = FLAGS[case] + ["--output_path", str(tmp_path)]
    root_full_eval.main(argv)
    want, seen[:] = list(seen), []
    pfull_eval.main(argv)
    py = sys.executable
    port = {f"{py} {s}.py": f"{py} -m priordepth_gaussiansplatting_torch.{s}"
            for s in ("train", "render", "metrics")}

    def as_port(cmd):
        for root, entry in port.items():
            if cmd.startswith(root + " "):
                return entry + cmd[len(root):]
        raise AssertionError(cmd)
    assert seen == [as_port(c) for c in want]
    # training (13 scenes), two renders each, one metrics run
    assert len(seen) == {"all": 13 + 26 + 1, "tat_only_no_training": 5}[case]
