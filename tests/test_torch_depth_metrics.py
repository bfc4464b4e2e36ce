"""The port's depth metrics (``depth/metrics.py``) against the JAX
package's on the CPU: ``compute_metrics`` with each crop and with inf and
NaN predictions, ``RunningAverageDict``, ``colorize`` byte for byte, and
``evaluate_dataset`` with and without TTA and border-aware inference, the
port's module against JAX's apply with the same weights (carried across
by ``interop``).

Tolerance: metrics 1e-6 relative (the same numpy code on the same
arrays); ``evaluate_dataset`` rtol 1e-4 (depths that agree to the depth
model suite's 1e-4)."""

import jax
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch.depth import data as pdata
from priordepth_gaussiansplatting_torch.depth import metrics as P
from priordepth_gaussiansplatting_tpu.depth import metrics as J
from tests.test_torch_depth_model import models

torch.set_num_threads(2)


def gt_pred(seed, h=60, w=80):
    rng = np.random.default_rng(seed)
    gt = (0.5 + 9 * rng.random((h, w))).astype(np.float32)
    gt[::7, ::5] = 0.0  # invalid
    pred = (gt * (0.8 + 0.4 * rng.random((h, w)))).astype(np.float32)
    pred[1, ::3] = np.inf
    pred[2, ::4] = np.nan
    pred[3, :5] = 20.0
    return gt, pred


@pytest.mark.parametrize("crop", [dict(), dict(garg_crop=True),
                                  dict(eigen_crop=True), dict(crop="garg"),
                                  dict(crop="eigen")])
def test_compute_metrics_matches_jax(crop):
    gt, pred = gt_pred(1)
    got = P.compute_metrics(gt.copy(), pred.copy(), **crop)
    want = J.compute_metrics(gt.copy(), pred.copy(), **crop)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_running_average_matches_jax():
    p, j = P.RunningAverageDict(), J.RunningAverageDict()
    assert p.get_value() == j.get_value() == {}
    for seed in range(3):
        gt, pred = gt_pred(seed, 20, 24)
        p.update(P.compute_metrics(gt.copy(), pred.copy()))
        j.update(J.compute_metrics(gt.copy(), pred.copy()))
    assert p.get_value() == j.get_value()


@pytest.mark.parametrize("kw", [dict(), dict(vmin=1.0, vmax=4.0),
                                dict(gamma_corrected=True, cmap="gray"),
                                dict(value_transform=np.square)])
def test_colorize_bytes_match_jax(kw):
    gt, _ = gt_pred(4, 16, 20)
    invalid = gt <= 0
    got = P.colorize(gt, invalid_mask=invalid, **kw)
    want = J.colorize(gt, invalid_mask=invalid, **kw)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (16, 20, 4)
    assert got.tobytes() == want.tobytes()
    const = np.full((4, 5), 2.0, np.float32)
    assert P.colorize(const).tobytes() == J.colorize(const).tobytes()


@pytest.fixture(scope="module")
def evaluation():
    """(jitted apply, params, port module, dataset): two 177x74 views
    letterboxed by 8 black rows (``get_black_border`` crops them to
    160x64, which the ViT's patch divides) and one 48x64 view."""
    apply, params, pm = models("depth", seed=11)
    rng = np.random.default_rng(12)
    samples = []
    for h, w, border in ((177, 74, 8), (177, 74, 8), (48, 64, 0)):
        img = 0.3 + 0.7 * rng.random((h, w, 3), dtype=np.float32)
        if border:
            img[:border] = img[-border:] = 0.0
        depth = (0.5 + 9 * rng.random((h, w))).astype(np.float32)
        samples.append(pdata.DepthSample(img, depth, depth > 0))
    return jax.jit(apply), params, pm, samples


@pytest.mark.parametrize("tta,avoid,first", [(True, False, 0),
                                             (False, False, 2),
                                             (True, True, 0),
                                             (False, True, 0)])
def test_evaluate_dataset_matches_jax(evaluation, tta, avoid, first):
    """Without TTA the model sees the image (or its crop) itself, so only
    views that the patch divides: the 48x64 one, or the letterboxed ones'
    crops (``limit`` 2)."""
    apply, params, pm, samples = evaluation
    samples = samples[first:]
    limit = 2 if (avoid and not tta) else None
    preset = pdata.DATASET_PRESETS["nyu"]
    want = J.evaluate_dataset(apply, params, samples, preset, use_tta=tta,
                              limit=limit, avoid_boundary=avoid)
    got = P.evaluate_dataset(pm, samples, preset, device="cpu",
                             use_tta=tta, limit=limit, avoid_boundary=avoid)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
