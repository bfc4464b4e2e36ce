"""The port's depth trainer (``depth/trainer.py``) against the JAX
package's on the CPU: ``onecycle_lr`` at every step of a 40-step
schedule; ``DepthModel`` (embed 64, 2 blocks, 8 bins, 32² views) from the
same weights (a flax tree drawn with numpy, carried across by
``interop``) on the same 8-sample batch: the global loss, the clipped
gradients of the first step, the losses and parameters of three steps;
``DepthModelNK`` one step; checkpoints written by either package loaded
by the other (the same forward), ``interop.depth_params_to_numpy`` the
exact inverse of ``depth_module_from_numpy``; a 2-rank gloo run (4
samples a rank) equal to the 1-rank port and to JAX, rank 0 alone writing
logs and checkpoints.

Tolerance: losses rtol 1e-5; gradients the suite's (atol 3e-4 x max|g|,
rtol 2e-3). Parameters after k steps are held by their change, in units
of lr·k, the sum of the k updates' learning rates (OneCycle's first
rates, not its peak): Adam's first updates are about lr·sign(g), so an
entry whose gradient is at rounding level in both packages can move by
±lr in one and not the other. At least 99.9 % of the entries must change
within 1e-3·lr·k of JAX's change, and every entry within 2·lr·k."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from priordepth_gaussiansplatting_torch import interop
from priordepth_gaussiansplatting_torch.depth import config as pcfg
from priordepth_gaussiansplatting_torch.depth import layers as PL
from priordepth_gaussiansplatting_torch.depth import model as PM
from priordepth_gaussiansplatting_torch.depth import trainer as P
from priordepth_gaussiansplatting_torch.parallel import mesh as pmesh
from priordepth_gaussiansplatting_torch.utils import testing
from priordepth_gaussiansplatting_tpu.depth import config as jcfg
from priordepth_gaussiansplatting_tpu.depth import losses as jlosses
from priordepth_gaussiansplatting_tpu.depth import model as JM
from priordepth_gaussiansplatting_tpu.depth import trainer as J
from tests.test_torch_depth_layers import close, nchw, random_params

torch.set_num_threads(2)
SMALL = dict(embed_dim=64, encoder_depth=2, n_bins=8)
H, B, STEPS = 32, 8, 3
TRAIN = dict(lr=3e-4, epochs=1, steps_per_epoch=10, max_depth=8.0)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3


class Preset:
    """A flax module whose ``init`` returns given parameters, so that the
    JAX trainer starts from the same weights as the port (and skips the
    eager init)."""

    def __init__(self, module, params):
        self.module, self.params = module, params

    def init(self, key, x):
        return jax.tree.map(jnp.asarray, self.params)

    def apply(self, *args, **kw):
        return self.module.apply(*args, **kw)


def batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    img = rng.random((b, H, H, 3), dtype=np.float32)
    depth = (0.3 + 7.5 * rng.random((b, H, H))).astype(np.float32)
    depth[:, :4] = np.inf  # sky rows, masked out as the proof masks them
    mask = np.isfinite(depth) & (rng.random((b, H, H)) > 0.2)
    depth = np.where(mask, depth, 1.0).astype(np.float32)
    return img, depth, mask


def setup(name, seed):
    """(flax module, flax variables, port module) of a small config."""
    jm = jcfg.build_model(jcfg.get_config(name, "train", "nyu", **SMALL))
    params = {"params": random_params(jm, [jnp.zeros((1, H, H, 3))], seed)}
    pm = pcfg.build_model(pcfg.get_config(name, "train", "nyu", **SMALL),
                          device="cpu")
    interop.depth_module_from_numpy(params, pm)
    return jm, params, pm


def flat_params(tree) -> dict:
    """{port name: array} of a flax variables tree."""
    return interop.depth_state_dict_from_numpy(
        jax.tree.map(np.asarray, tree))


def state(module) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def adam_close(got: dict, want: dict, before: dict, k: int):
    """The changes of `got` and `want` from `before` at the Adam tolerance
    of k steps (module docstring)."""
    lr_k = sum(P.onecycle_lr(s, TRAIN["steps_per_epoch"], TRAIN["lr"])
               for s in range(k))
    share, worst = testing.adam_agreement(got, want, before, lr_k)
    assert share >= 0.999 and worst <= 2, (share, worst)
    moved = np.concatenate([np.abs(want[n] - before[n]).ravel()
                            for n in before])
    assert 0.5 * lr_k < moved.max() < 2 * lr_k


@pytest.mark.parametrize("total,max_lr", [(40, 3e-4), (7, 1e-3)])
def test_onecycle_lr_matches_jax(total, max_lr):
    for step in range(total + 2):
        np.testing.assert_allclose(
            P.onecycle_lr(step, total, max_lr),
            float(J.onecycle_lr(step, total, max_lr)), rtol=1e-6,
            err_msg=str(step))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer and the port's trainer three steps from the same
    weights on the same batch, the first step's clipped gradients of both,
    and their checkpoint directories."""
    tmp = tmp_path_factory.mktemp("depth_trainer")
    jm, params, pm = setup("depth", seed=3)
    img, depth, mask = batch(0)
    before = state(pm)

    def loss_fn(p, x, d, m):  # the JAX trainer's loss (trainer.py:103-114)
        pred = jnp.clip(jm.apply(p, x)["metric_depth"], 1e-3, 8.0)
        return (jlosses.silog_loss(pred, d, m)
                + 0.5 * jlosses.grad_l1_loss(pred, d, m))
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(img), jnp.asarray(depth), jnp.asarray(mask))
    jclipped, _ = optax.clip_by_global_norm(0.1).update(jgrads, None)

    jt = J.DepthTrainer(Preset(jm, params), J.DepthTrainerConfig(
        **TRAIN, checkpoint_dir=str(tmp / "jax")))
    jt.init(jnp.zeros((1, H, H, 3)))
    pt = P.DepthTrainer(pm, P.DepthTrainerConfig(
        **TRAIN, checkpoint_dir=str(tmp / "port")), device="cpu")
    ploss, pgrads = pt.gradients(img, depth, mask)
    pclipped = [g.clone() for g in pgrads]
    P.clip_by_global_norm_(pclipped, P.CLIP_NORM)
    names = [n for n, _ in pm.named_parameters()]
    out = dict(jm=jm, params=params, pm=pm, jt=jt, pt=pt, before=before,
               jloss=float(jloss), ploss=float(ploss), tmp=tmp,
               jgrads=(flat_params(jgrads), flat_params(jclipped)),
               pgrads=({n: g.numpy() for n, g in zip(names, pgrads)},
                       {n: g.numpy() for n, g in zip(names, pclipped)}),
               losses=[], batch=(img, depth, mask))
    for _ in range(STEPS):
        out["losses"].append((jt.train_step(*map(jnp.asarray, (img, depth,
                                                                mask))),
                              pt.train_step(img, depth, mask)))
    out["after"] = (flat_params(jt.params), state(pm))
    return out


def test_first_step_loss_and_clipped_gradients_match_jax(runs):
    np.testing.assert_allclose(runs["ploss"], runs["jloss"], rtol=LOSS_RTOL)
    for got, want in zip(runs["pgrads"], runs["jgrads"]):
        scale = max(np.abs(w).max() for w in want.values())
        for n, w in want.items():
            np.testing.assert_allclose(got[n], w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL * scale, err_msg=n)
    # The global norm exceeds 0.1, so the clip acts.
    norm = np.sqrt(sum(np.sum(g ** 2) for g in runs["pgrads"][0].values()))
    assert norm > 0.1


def test_three_steps_match_jax(runs):
    for j, p in runs["losses"]:
        np.testing.assert_allclose(p, j, rtol=LOSS_RTOL)
    assert runs["losses"][-1][1] < runs["losses"][0][1]
    jax_after, port_after = runs["after"]
    adam_close(port_after, jax_after, runs["before"], STEPS)


def test_depth_model_nk_step_matches_jax():
    """The NK router trains through its soft route on SILog + GradL1: no
    domain label reaches the loss (JAX ``trainer.py:121-123``)."""
    jm, params, pm = setup("depth_nk", seed=4)
    before = state(pm)
    img, depth, mask = batch(1)
    jt = J.DepthTrainer(Preset(jm, params), J.DepthTrainerConfig(**TRAIN))
    jt.init(jnp.zeros((1, H, H, 3)))
    pt = P.DepthTrainer(pm, P.DepthTrainerConfig(**TRAIN), device="cpu")
    want = jt.train_step(*map(jnp.asarray, (img, depth, mask)))
    got = pt.train_step(img, depth, mask)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    adam_close(state(pm), flat_params(jt.params), before, 1)


def forward_pair(runs, x):
    """(port forward, JAX forward) of the runs' two trainers' weights."""
    with torch.no_grad():
        got = runs["pm"](nchw(x))["metric_depth"].numpy()
    want = jax.jit(runs["jm"].apply)(runs["jt"].params,
                                     jnp.asarray(x))["metric_depth"]
    return got, np.asarray(want)


def test_checkpoints_load_in_either_package(runs):
    """The port's checkpoint in JAX's trainer, then JAX's in the port's:
    the same forward, the step kept, the optimizer state fresh."""
    jt, pt, tmp = runs["jt"], runs["pt"], runs["tmp"]
    x = batch(2, 2)[0]
    pt.save_checkpoint("port.pkl")
    with open(tmp / "port" / "port.pkl", "rb") as f:
        payload = pickle.load(f)
    assert set(payload) == {"params", "step"} and payload["step"] == STEPS
    assert set(payload["params"]) == {"params"}
    jt.load_checkpoint(str(tmp / "port" / "port.pkl"))
    assert jt.step_count == STEPS
    got, want = forward_pair(runs, x)
    close(got, want, "port checkpoint in JAX")
    # Move JAX's weights away from the port's, save, and load them back.
    jt.params = jax.tree.map(lambda a: a * 1.01, jt.params)
    jt.step_count = 7
    jt.save_checkpoint("jax.pkl")
    pt.load_checkpoint(str(tmp / "jax" / "jax.pkl"))
    assert pt.step_count == 7 and pt.opt_count == 0
    assert all(float(m.abs().max()) == 0 for m in pt.mu + pt.nu)
    got, want = forward_pair(runs, x)
    close(got, want, "JAX checkpoint in the port")


def dinov2_encoder():
    kw = dict(embed_dim=32, depth=2, num_heads=4, patch_size=8, taps=(0,),
              use_cls_token=True, num_register_tokens=2, layerscale=True,
              final_norm=True, pos_rows=64)
    return JM.ViTEncoder(**kw), PL.build(PM.ViTEncoder, **kw, device="cpu")


@pytest.mark.parametrize("name", ["depth_nk", "dinov2_encoder"])
def test_inverse_interop_round_trip_is_exact(name):
    """JAX tree -> port module -> JAX tree: the same keys, shapes and
    bits (the router's and the encoder's attention kernels, LayerNorm
    scales, tokens, LayerScale)."""
    if name == "depth_nk":
        _, params, pm = setup(name, seed=5)
    else:
        jm, pm = dinov2_encoder()
        params = {"params": random_params(jm, [jnp.zeros((1, 16, 16, 3))],
                                          6)}
        interop.depth_module_from_numpy(params, pm)
    back = interop.depth_params_to_numpy(pm)
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, params))[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.astype(np.float32).view(np.int32))


def _rank(rank, world, params, img, depth, mask, tmp):
    """One rank of the 2-rank run (module level, so that spawn can import
    it): its rows of the global batch, 3 steps, then a checkpoint and an
    eval log on every rank's trainer."""
    torch.set_num_threads(1)
    pm = pcfg.build_model(pcfg.get_config("depth", "train", "nyu", **SMALL),
                          device="cpu")
    interop.depth_module_from_numpy(params, pm)
    cfg = P.DepthTrainerConfig(**TRAIN, log_every=1,
                               log_dir=os.path.join(tmp, f"logs{rank}"),
                               checkpoint_dir=os.path.join(tmp, f"ck{rank}"))
    pt = P.DepthTrainer(pm, cfg, device="cpu")
    rows = slice(rank * B // world, (rank + 1) * B // world)
    losses = [pt.train_step(img[rows], depth[rows], mask[rows])
              for _ in range(STEPS)]
    pt.save_checkpoint()
    pt.log_eval({"a1": 0.5})
    pt.log_depth_images(img[:1], depth[:1], depth[:1])
    return losses, state(pm)


def test_two_ranks_equal_one_rank_and_jax(runs, tmp_path):
    img, depth, mask = runs["batch"]
    params = jax.tree.map(np.asarray, runs["params"])
    out = pmesh.spawn(2, _rank, params, img, depth, mask, str(tmp_path),
                      backend="gloo", store_dir=str(tmp_path), timeout=240)
    (l0, s0), (l1, s1) = out
    assert l0 == l1
    for name in s0:  # the replicas stay equal
        np.testing.assert_array_equal(s0[name], s1[name])
    one_rank = [p for _, p in runs["losses"]]
    jax_losses = [j for j, _ in runs["losses"]]
    np.testing.assert_allclose(l0, one_rank, rtol=LOSS_RTOL)
    np.testing.assert_allclose(l0, jax_losses, rtol=LOSS_RTOL)
    jax_after, port_after = runs["after"]
    adam_close(s0, port_after, runs["before"], STEPS)
    adam_close(s0, jax_after, runs["before"], STEPS)
    # Rank 0 alone writes: its log (a loss a step, the eval, three
    # images) and its checkpoint; rank 1 nothing.
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["ck0", "logs0"] + [f for f in os.listdir(tmp_path)
                            if f.startswith("store")])
    assert os.listdir(tmp_path / "ck0") == ["latest.pkl"]
    with open(tmp_path / "logs0" / "events.jsonl") as f:
        tags = [line.split('"tag": "')[1].split('"')[0] for line in f]
    assert tags == ["Train/loss"] * STEPS + ["Metrics/a1"] + [
        "Eval/input", "Eval/gt", "Eval/pred"]
