"""The port's depth models and inference (``depth/model.py``,
``depth/infer.py``, ``depth/preprocess.py``) against the JAX package's on
the CPU: ``DepthModel`` and ``DepthModelNK`` (soft and hard route) at
embed 64, 2 blocks and 8 bins on a 64² input with the same weights (a flax
tree drawn with numpy, carried across by ``interop``), TTA with and
without the flip, the 16-bit prior PNGs, the positional table's limit and
the border-aware inference.

Tolerance: rtol 1e-4, atol 1e-5 x max|x| of the JAX output; prior PNGs
within one level of 65,535 (the 16-bit rounding of depths that agree to
that tolerance), and byte for byte for the same depth array."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.depth import config as pcfg
from priordepth_gaussiansplatting_torch.depth import infer as pinfer
from priordepth_gaussiansplatting_torch.depth import preprocess as ppre
from priordepth_gaussiansplatting_tpu.depth import config as jcfg
from priordepth_gaussiansplatting_tpu.depth import infer as jinfer
from priordepth_gaussiansplatting_tpu.depth import preprocess as jpre
from tests.test_torch_depth_layers import close, nchw, random_params

torch.set_num_threads(2)
SMALL = dict(embed_dim=64, encoder_depth=2, n_bins=8)


def models(name, seed=0, **kw):
    """(jitted flax apply, flax params, port module) of one config."""
    cfg = dict(SMALL, **kw)
    jm = jcfg.build_model(jcfg.get_config(name, "infer", "nyu", **cfg))
    params = {"params": random_params(jm, [jnp.zeros((1, 64, 64, 3))],
                                      seed)}
    pm = pcfg.build_model(pcfg.get_config(name, "infer", "nyu", **cfg),
                          device="cpu")
    interop.depth_module_from_numpy(params, pm)
    apply = jax.jit(jm.apply, static_argnames=("hard_route",)
                    if name == "depth_nk" else ())
    return apply, params, pm.eval()


@pytest.fixture(scope="module")
def depth_models():
    return models("depth", seed=1)


def image(seed, h, w):
    return np.random.default_rng(seed).random((1, h, w, 3),
                                              dtype=np.float32)


@pytest.mark.parametrize("bins", ["softplus", "normed"])
def test_depth_model_matches_jax(bins):
    apply, params, pm = models("depth", seed=2, bin_centers_type=bins)
    x = np.concatenate([image(3, 64, 64), image(4, 64, 64)])
    want = apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = pm(nchw(x))
    assert got["metric_depth"].shape == (2, 64, 64)
    assert got["probs"].shape == (2, 8, 32, 32)
    for key in ("metric_depth", "rel_depth"):
        close(got[key].numpy(), want[key], key)
    for key in ("probs", "bin_centers"):
        close(got[key].numpy().transpose(0, 2, 3, 1), want[key], key)


@pytest.mark.parametrize("hard", [False, True])
def test_depth_model_nk_matches_jax(hard):
    apply, params, pm = models("depth_nk", seed=5)
    x = np.concatenate([image(6, 64, 64), 0.3 * image(7, 64, 64)])
    want = apply(params, jnp.asarray(x), hard_route=hard)
    with torch.no_grad():
        got = pm(nchw(x), hard_route=hard)
    for key in ("metric_depth", "rel_depth", "domain_logits"):
        close(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("flip", [True, False])
def test_infer_with_tta_matches_jax(depth_models, flip):
    """A 48x56 image reflect-padded to 128x128: the bottom pad of 48 rows
    is as long as the image, so numpy's reflection wraps."""
    apply, params, pm = depth_models
    x = image(8, 48, 56)
    want = jinfer.infer_with_tta(apply, params, jnp.asarray(x),
                                 with_flip=flip)
    got = pinfer.infer_with_tta(pm, torch.from_numpy(x), with_flip=flip)
    assert got.shape == (1, 48, 56) and not got.requires_grad
    close(got.numpy(), want)


def test_generate_depth_priors_matches_jax(depth_models, tmp_path):
    """Three images (one a JPEG, one a second PNG, a text file skipped)
    through both packages' batch jobs; then the same depth array through
    both PNG writers, byte for byte."""
    apply, params, pm = depth_models
    images = tmp_path / "images"
    images.mkdir()
    for i, (h, w, ext) in enumerate([(40, 48, "png"), (48, 40, "jpg"),
                                     (32, 32, "png")]):
        arr = (image(10 + i, h, w)[0] * 255).astype(np.uint8)
        Image.fromarray(arr).save(images / f"view_{i}.{ext}")
    (images / "notes.txt").write_text("not an image")
    want = jinfer.generate_depth_priors(apply, params, str(images),
                                        str(tmp_path / "jax"))
    got = pinfer.generate_depth_priors(pm, str(images),
                                       str(tmp_path / "port"), device="cpu")
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == [f"view_{i}.png"
                                               for i in range(3)]
    for g, w in zip(got, want):
        a = np.asarray(Image.open(g), np.int64)
        b = np.asarray(Image.open(w), np.int64)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, g
    depth = 0.5 + np.random.default_rng(14).random((40, 48),
                                                   dtype=np.float32)
    pinfer.save_invdepth_png(str(tmp_path / "a.png"), depth)
    jinfer.save_invdepth_png(str(tmp_path / "b.png"), depth)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png"
                                                 ).read_bytes()


def test_tta_positional_limit_matches_jax():
    """TTA pads a 512² image to 1,024² (64² = 4,096 patches, the table's
    rows exactly); a 544² image pads past it, and both packages refuse
    it: JAX on the broadcast, the port with a ValueError that names the
    limit."""
    for side, padded in ((512, 1024), (544, 1088)):
        ph = max(int(np.sqrt(side / 2) * 0.03 * side), 32)
        assert -(-(side + 2 * ph) // 32) * 32 == padded
    apply, params, pm = models("depth", seed=15, embed_dim=32,
                               encoder_depth=1)
    x = np.zeros((1, 544, 544, 3), np.float32)
    with pytest.raises((TypeError, ValueError)):
        jinfer.infer_with_tta(apply, params, jnp.asarray(x))
    with pytest.raises(ValueError, match="4096 rows.*1024x1024 px"):
        pinfer.infer_with_tta(pm, torch.from_numpy(x))


def test_crop_aware_infer_matches_jax(depth_models):
    """A 128² image with a black border of 6 pixels: both packages find
    it (its far edges one row and column inside the image, the reference's
    scan), infer on the 115² crop by TTA and zero-pad back."""
    apply, params, pm = depth_models
    img = 0.2 + 0.8 * image(16, 128, 128)[0]
    img[:6], img[-6:], img[:, :6], img[:, -6:] = 0, 0, 0, 0
    want = jpre.crop_aware_infer(
        lambda c: jinfer.infer_with_tta(apply, params,
                                        jnp.asarray(c)[None])[0], img)
    got = ppre.crop_aware_infer(
        lambda c: pinfer.infer_with_tta(pm, torch.from_numpy(
            np.ascontiguousarray(c))[None])[0].numpy(), img)
    u8 = (img * 255).astype(np.uint8)
    crop = dataclasses.astuple(ppre.get_black_border(u8))
    assert crop == dataclasses.astuple(jpre.get_black_border(u8))
    assert crop == (6, 121, 6, 121)
    assert (got[:6] == 0).all() and (got[6:121, 6:121] > 0).all()
    close(got, want)
