"""The port's depth layers (``depth/layers.py``) and ViT encoder against
the JAX package's flax modules on the CPU: the same seeded numpy inputs,
the same weights (a flax tree drawn with numpy, biases, LayerScale and
the class position away from their initial values, carried across by
``interop.depth_module_from_numpy``).

Tolerance: rtol 1e-4, atol 1e-5 x max|x| of the JAX output (features,
bins and depths alike)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.depth import layers as P
from priordepth_gaussiansplatting_torch.depth import model as PM
from priordepth_gaussiansplatting_tpu.depth import layers as J
from priordepth_gaussiansplatting_tpu.depth import model as JM

torch.set_num_threads(2)
RTOL, ATOL_REL = 1e-4, 1e-5


def close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want).max()),
                               err_msg=what)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def random_params(jmod, inputs, seed):
    """A flax parameter tree for `jmod` on `inputs`, drawn with numpy:
    kernels N(0, 1/fan_in), LayerNorm scales and LayerScale 1 + N(0, 0.1),
    the rest N(0, 0.1) (biases and the class position away from 0). Only
    the shapes come from flax (``eval_shape``: nothing compiles)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            *inputs)["params"]

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) != 3
                               or path[-2].key == "out" else s.shape[0])
        return 0.1 * x + (name == "scale" or name.startswith("ls"))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def carried(jmod, pmod, inputs, seed=0):
    """(flax params, port module with them): random parameters of `jmod`
    on `inputs`, loaded into `pmod` (made on the CPU)."""
    params = random_params(jmod, inputs, seed)
    return params, interop.depth_module_from_numpy(params, pmod)


def apply(jmod, params, *inputs, **kw):
    """The flax module's forward, jitted (one compile, not one per op)."""
    with jax.default_matmul_precision("highest"):
        return jax.jit(functools.partial(jmod.apply, **kw))(
            {"params": params}, *inputs)


def rand(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("src,dst", [((5, 7), (1, 1)), ((5, 7), (1, 9)),
                                     ((4, 4), (9, 13)), ((9, 13), (4, 6)),
                                     ((6, 6), (6, 6)), ((1, 1), (3, 4))])
def test_resize_align_corners_matches_jax(src, dst):
    x = rand(1, 2, *src, 3)
    want = jax.jit(J.resize_align_corners, static_argnums=1)(
        jnp.asarray(x), dst)
    got = P.resize_align_corners(nchw(x), dst)
    assert got.shape == (2, 3) + dst
    close(nhwc(got), want)


@pytest.mark.parametrize("src,dst", [((37, 37), (24, 24)), ((4, 4), (32, 32)),
                                     ((8, 6), (16, 12)), ((16, 16), (5, 7)),
                                     ((24, 24), (37, 37))])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    """Half-pixel centres and border renormalisation when upsampling, the
    antialiasing filter when shrinking (a 37² positional grid to 24²)."""
    x = rand(2, 1, *src, 4)
    want = jax.image.resize(jnp.asarray(x), (1,) + dst + (4,), "bilinear")
    close(nhwc(P.resize_bilinear(nchw(x), dst)), want)


@pytest.mark.parametrize("name", ["SeedBinRegressor",
                                  "SeedBinRegressorUnnormed", "Projector"])
def test_seed_regressors_and_projector_match_jax(name):
    x = rand(3, 2, 5, 6, 16)
    kw = {} if name == "Projector" else dict(n_bins=8, min_depth=0.1,
                                             max_depth=8.0)
    jmod = getattr(J, name)(**kw)
    pmod = P.build(getattr(P, name), 16, **kw, device="cpu")
    params, pmod = carried(jmod, pmod, [jnp.asarray(x)], seed=4)
    want = apply(jmod, params, jnp.asarray(x))
    with torch.no_grad():
        got = pmod(nchw(x))
    if name == "Projector":
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        close(nhwc(g), w, name)


@pytest.mark.parametrize("normed", [True, False])
@pytest.mark.parametrize("kind", ["sum", "mean"])
@pytest.mark.parametrize("attractor_type", ["exp", "inv"])
def test_attractor_layers_match_jax(normed, kind, attractor_type):
    """Both classes, both kinds and both attractor types; the previous
    bins and embedding come at a coarser grid (align-corners upsampling)."""
    emb, n_bins = 16, 8
    x = rand(5, 2, 6, 5, emb)
    b_prev = rand(6, 2, 3, 3, n_bins) * (1.0 if normed else 4.0)
    prev = rand(7, 2, 3, 3, emb)
    kw = dict(n_bins=n_bins, n_attractors=4, alpha=300.0, gamma=2,
              kind=kind, attractor_type=attractor_type, min_depth=0.1,
              max_depth=8.0)
    cls = "AttractorLayer" if normed else "AttractorLayerUnnormed"
    jmod = getattr(J, cls)(**kw)
    inputs = [jnp.asarray(a) for a in (x, b_prev, prev)]
    params, pmod = carried(jmod, P.build(getattr(P, cls), emb, **kw,
                                         device="cpu"), inputs, seed=8)
    want = apply(jmod, params, *inputs)
    with torch.no_grad():
        got = pmod(nchw(x), nchw(b_prev), nchw(prev))
    for g, w in zip(got, want):
        close(nhwc(g), w, cls)


def test_conditional_log_binomial_matches_jax():
    """The exact GELU and the log-binomial's n == k guard (its last bin's
    probability stays finite)."""
    feat, cond = rand(9, 2, 7, 6, 12), rand(10, 2, 7, 6, 10)
    jmod = J.ConditionalLogBinomial(n_bins=8, min_temp=0.0212, max_temp=50.0)
    inputs = [jnp.asarray(feat), jnp.asarray(cond)]
    params, pmod = carried(jmod, P.build(
        P.ConditionalLogBinomial, 22, n_bins=8, min_temp=0.0212,
        max_temp=50.0, device="cpu"), inputs, seed=11)
    want = apply(jmod, params, *inputs)
    with torch.no_grad():
        got = pmod(nchw(feat), nchw(cond))
    assert torch.isfinite(got).all()
    close(nhwc(got), want)


@pytest.mark.parametrize("grid", [(4, 4), (13, 13), (20, 23)])
def test_patch_transformer_matches_jax(grid):
    """The 10x10 stride-10 patch convolution pads as flax's SAME, also
    asymmetrically on a grid not divisible by 10; tanh GELU, LayerNorm
    eps 1e-6."""
    x = rand(12, 2, *grid, 16)
    jmod = J.PatchTransformerEncoder(embed_dim=32, num_heads=4, num_layers=2)
    params, pmod = carried(jmod, P.build(
        P.PatchTransformerEncoder, 16, embed_dim=32, num_heads=4,
        num_layers=2, device="cpu"), [jnp.asarray(x)], seed=13)
    want = apply(jmod, params, jnp.asarray(x))
    with torch.no_grad():
        got = pmod(nchw(x))
    assert got.shape == want.shape == (2, 1 + -(-grid[0] // 10)
                                       * -(-grid[1] // 10), 32)
    close(got.numpy(), want)


VIT_OPTIONS = {
    "default": {},
    "exact_gelu": dict(exact_gelu=True),
    "ln_eps": dict(ln_eps=1e-6),
    "cls": dict(use_cls_token=True),
    "registers": dict(num_register_tokens=3),
    "dinov2": dict(use_cls_token=True, num_register_tokens=2,
                   layerscale=True, final_norm=True, exact_gelu=True),
    "layerscale_norm": dict(layerscale=True, final_norm=True),
}


@pytest.mark.parametrize("option", sorted(VIT_OPTIONS))
def test_vit_encoder_options_match_jax(option):
    """Every ViTEncoder option, at embed 48, 2 blocks, 3 heads, patch 8,
    a 40x32 input (the positional table of 64 rows sliced to 20), taps
    after blocks 0 and 1."""
    kw = dict(embed_dim=48, depth=2, num_heads=3, patch_size=8, taps=(0,),
              pos_rows=64, **VIT_OPTIONS[option])
    x = rand(14, 2, 40, 32, 3)
    jmod = JM.ViTEncoder(**kw)
    params, pmod = carried(jmod, P.build(PM.ViTEncoder, **kw, device="cpu"),
                           [jnp.asarray(x)], seed=15)
    want = apply(jmod, params, jnp.asarray(x))
    with torch.no_grad():
        got = pmod(nchw(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (2, 48, 5, 4)
        close(nhwc(g), w, option)


def test_attention_routes_agree():
    """The fused route falls back to the plain form on the CPU; the plain
    form equals flax's attention (the layer tests above), and
    ``use_fused_attention`` sets every layer."""
    enc = P.build(PM.ViTEncoder, embed_dim=32, depth=2, num_heads=2,
                  patch_size=8, taps=(), pos_rows=16, device="cpu")
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = enc(x)[-1]
        P.use_fused_attention(enc, False)
        assert not any(m.fused for m in enc.modules()
                       if isinstance(m, P.SelfAttention))
        b = enc(x)[-1]
    assert torch.equal(a, b)


def test_positional_table_refusal_matches_jax():
    """More patches than positional rows: JAX fails on the broadcast, the
    port raises a ValueError that names the limit; one patch fewer runs in
    both."""
    kw = dict(embed_dim=16, depth=1, num_heads=2, patch_size=8, taps=(),
              pos_rows=16)
    jmod = JM.ViTEncoder(**kw)
    small = jnp.zeros((1, 32, 32, 3))
    params, pmod = carried(jmod, P.build(PM.ViTEncoder, **kw, device="cpu"),
                           [small])
    big = np.zeros((1, 40, 32, 3), np.float32)  # 5 x 4 = 20 patches
    with pytest.raises((TypeError, ValueError)):
        apply(jmod, params, jnp.asarray(big))
    with pytest.raises(ValueError, match="16 rows.*32x32 px"):
        pmod(nchw(big))
    ok = np.zeros((1, 32, 32, 3), np.float32)
    assert len(apply(jmod, params, jnp.asarray(ok))) == len(pmod(nchw(ok)))


def test_carried_weights_name_the_leaf():
    """A flax tree of another geometry fails, naming the leaf."""
    jmod = J.Projector(out_features=8)
    params = random_params(jmod, [jnp.zeros((1, 2, 2, 6))], 0)
    bad = P.build(P.Projector, 5, out_features=8, device="cpu")
    with pytest.raises(ValueError, match="Conv_0.weight"):
        interop.depth_module_from_numpy(params, bad)
    with pytest.raises(ValueError, match="Conv_1"):
        interop.depth_module_from_numpy(
            {"Conv_0": params["Conv_0"]},
            P.build(P.Projector, 6, out_features=8, device="cpu"))


def test_build_draws_from_the_generator():
    """``build`` takes its weights from the generator alone: the same seed
    gives the same module, the global RNG is untouched."""
    state = torch.random.get_rng_state()
    a = P.build(P.PatchTransformerEncoder, 8, embed_dim=16, num_layers=1,
                generator=torch.Generator().manual_seed(3), device="cpu")
    b = P.build(P.PatchTransformerEncoder, 8, embed_dim=16, num_layers=1,
                generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert float(a.pos_embed.detach().std()) == pytest.approx(0.02, rel=0.1)
    assert float(a.LayerNorm_0.weight.detach().min()) == 1.0
