"""The port's checkpoint importer (``depth/import_torch.py``) against the
JAX package's, on state dicts that the test writes (no pretrained weights):
a tiny timm ViT, the DINOv2/DepthAnythingV2 layout with and without the
``pretrained.`` prefix, and a ZoeDepth metric head. Each goes through both
importers; the port's state dict must equal the JAX tree carried across
by ``interop``, and the port's forward must match JAX's and the torch
module's.

Tolerance: rtol 1e-4, atol 1e-5 x max|x| against JAX; atol 1e-4, rtol 2e-4
against the torch modules (the JAX suite's own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.depth import import_torch as pit
from priordepth_gaussiansplatting_torch.depth import layers as P
from priordepth_gaussiansplatting_torch.depth import model as PM
from priordepth_gaussiansplatting_tpu.depth import import_torch as jit_
from priordepth_gaussiansplatting_tpu.depth import model as JM
from tests.test_depth_import import (TinyTorchDinoV2, TinyTorchViT,
                                     TinyTorchZoeHead)
from tests.test_torch_depth_layers import close

torch.set_num_threads(2)


def same_tree(port_sd, jax_params):
    """The port's state dict equals the JAX tree carried across."""
    carried = interop.depth_state_dict_from_numpy(
        jax.tree.map(np.asarray, jax_params))
    assert sorted(carried) == sorted(port_sd)
    for k, v in port_sd.items():
        np.testing.assert_array_equal(v.numpy(), carried[k], err_msg=k)


def written(tmp_path, sd, wrap=None):
    """`sd` saved with torch.save (optionally under a wrapper key with
    DDP ``module.`` prefixes), loaded back by both packages."""
    obj = sd if wrap is None else {wrap: {"module." + k: v
                                          for k, v in sd.items()}}
    path = str(tmp_path / "ckpt.pth")
    torch.save(obj, path)
    return pit.load_state_dict(path), jit_.load_state_dict(path)


def test_timm_vit_imports_like_jax(tmp_path):
    torch.manual_seed(0)
    model = TinyTorchViT().eval()
    sd_p, sd_j = written(tmp_path, model.state_dict(), wrap="model")
    got_sd, geo = pit.convert_vit_state_dict(sd_p, target_grid=(4, 4),
                                             pos_table_rows=64, num_heads=2)
    params, geo_j = jit_.convert_vit_state_dict(sd_j, target_grid=(4, 4),
                                                pos_table_rows=64,
                                                num_heads=2)
    assert geo == geo_j
    same_tree(got_sd, params)
    kw = dict(embed_dim=32, depth=2, num_heads=2, patch_size=8, taps=(),
              exact_gelu=True, pos_rows=64)
    enc = P.build(PM.ViTEncoder, **kw, device="cpu")
    enc.load_state_dict(got_sd)
    x = np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32)
    want = jax.jit(JM.ViTEncoder(**kw).apply)({"params": params},
                                              jnp.asarray(x))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = enc(xt)[-1]
        ref = model(xt)
    close(got.numpy().transpose(0, 2, 3, 1), want[-1])
    np.testing.assert_allclose(got.flatten(2).transpose(1, 2).numpy(),
                               ref.numpy(), atol=1e-4, rtol=2e-4)


@pytest.mark.parametrize("prefix", ["", "pretrained."])
def test_dinov2_dav2_imports_like_jax(prefix, tmp_path):
    """Class token with its own positional row, registers after the
    positional add, LayerScale, the final norm on every tap."""
    torch.manual_seed(3)
    model = TinyTorchDinoV2().eval()
    sd = {prefix + k: v for k, v in model.state_dict().items()}
    sd_p, sd_j = written(tmp_path, sd)
    got_sd, geo = pit.convert_vit_state_dict(sd_p, target_grid=(4, 4),
                                             pos_table_rows=64, num_heads=2)
    params, geo_j = jit_.convert_vit_state_dict(sd_j, target_grid=(4, 4),
                                                pos_table_rows=64,
                                                num_heads=2)
    assert geo == geo_j and geo["num_register_tokens"] == 2
    assert geo["use_cls_token"] and geo["layerscale"] and geo["final_norm"]
    same_tree(got_sd, params)
    kw = dict(embed_dim=32, depth=2, num_heads=2, patch_size=8, taps=(0,),
              exact_gelu=True, pos_rows=64, use_cls_token=True,
              num_register_tokens=2, layerscale=True, final_norm=True)
    enc = P.build(PM.ViTEncoder, **kw, device="cpu")
    enc.load_state_dict(got_sd)
    x = np.random.RandomState(5).rand(1, 32, 32, 3).astype(np.float32)
    want = jax.jit(JM.ViTEncoder(**kw).apply)({"params": params},
                                              jnp.asarray(x))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = enc(xt)
        ref = model(xt)
    assert len(got) == len(want) == len(ref) == 2
    for g, w, r in zip(got, want, ref):
        close(g.numpy().transpose(0, 2, 3, 1), w)
        np.testing.assert_allclose(g.flatten(2).transpose(1, 2).numpy(),
                                   r.numpy(), atol=1e-4, rtol=2e-4)


def test_zoedepth_head_imports_like_jax(tmp_path):
    torch.manual_seed(7)
    head = TinyTorchZoeHead().eval()
    sd_p, sd_j = written(tmp_path, head.state_dict(), wrap="state_dict")
    got_sd, geo = pit.convert_zoedepth_head_state_dict(sd_p)
    params, geo_j = jit_.convert_zoedepth_head_state_dict(sd_j)
    assert geo == geo_j == {"n_bins": 8, "bin_embedding_dim": 16,
                            "btlnck_features": 16, "attractors": (4, 2)}
    same_tree(got_sd, params)
    port_head = P.build(PM.MetricBinsHead, (16, 12, 10, 6), n_bins=8,
                        bin_embedding_dim=16, attractors=(4, 2),
                        btlnck_features=16, device="cpu")
    port_head.load_state_dict(got_sd)
    rng = np.random.RandomState(11)
    taps = [rng.rand(1, c, s, s).astype(np.float32)
            for c, s in ((16, 4), (12, 4), (10, 8), (6, 16))]
    rel = rng.rand(1, 32, 32).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(JM.MetricBinsHead(
            n_bins=8, bin_embedding_dim=16, attractors=(4, 2),
            btlnck_features=16).apply)(
                {"params": params},
                [jnp.asarray(t.transpose(0, 2, 3, 1)) for t in taps],
                jnp.asarray(rel))
    with torch.no_grad():
        got = port_head([torch.from_numpy(t) for t in taps],
                        torch.from_numpy(rel))
        ref = head([torch.from_numpy(t) for t in taps],
                   torch.from_numpy(rel))
    close(got[0].numpy(), want[0], "depth")
    for g, w in zip(got[1:], want[1:]):
        close(g.numpy().transpose(0, 2, 3, 1), w)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("grid,target,cls", [(37, (24, 24), True),
                                             (4, (8, 8), False),
                                             (4, (4, 4), True),
                                             (16, (5, 7), False)])
def test_resample_pos_embed_matches_jax(grid, target, cls):
    """DINOv2's 37² table to the default 24² (antialiased, as
    ``jax.image.resize`` shrinks), an upsampling, the identity, and a
    non-square target."""
    rng = np.random.RandomState(grid)
    pos = rng.rand(1, grid * grid + cls, 8).astype(np.float32)
    got = pit.resample_pos_embed(pos, target)
    want = jit_.resample_pos_embed(pos, target)
    assert got.shape == want.shape == (target[0] * target[1], 8)
    close(got, want)
    if target == (grid, grid):
        np.testing.assert_allclose(got, pos[0, cls:], atol=1e-6)


def test_graft_validates_names_and_shapes():
    torch.manual_seed(0)
    sd, _ = pit.convert_vit_state_dict(TinyTorchViT().state_dict(),
                                       target_grid=(4, 4), num_heads=2)
    model = P.build(PM.DepthModel, embed_dim=32, encoder_depth=2, n_bins=8,
                    device="cpu")
    model.ViTEncoder_0 = P.build(PM.ViTEncoder, embed_dim=32, depth=2,
                                 num_heads=2, patch_size=8, taps=(1,),
                                 exact_gelu=True, device="cpu")
    out = pit.graft_encoder_params(model.state_dict(), sd)
    model.load_state_dict(out)
    assert torch.equal(model.ViTEncoder_0.Conv_0.weight,
                       sd["Conv_0.weight"])
    bad = dict(sd, **{"Conv_0.weight": torch.zeros(32, 3, 4, 4)})
    with pytest.raises(ValueError, match="ViTEncoder_0.Conv_0.weight"):
        pit.graft_encoder_params(model.state_dict(), bad)
    short = {k: v for k, v in sd.items() if k != "pos_embed"}
    with pytest.raises(ValueError, match="pos_embed"):
        pit.graft_encoder_params(model.state_dict(), short)
    with pytest.raises(KeyError, match="Encoder_9"):
        pit.graft_encoder_params(model.state_dict(), sd, scope="Encoder_9")
