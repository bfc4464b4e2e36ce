"""The port's depth losses (``depth/losses.py``) against the JAX package's
on the CPU: every loss's value and its gradient (autograd against
``jax.grad``) on the same seeded numpy inputs, (B, H, W) maps and (B, K,
H, W) bin probabilities, with a random mask, an empty mask, a singular
scale-and-shift system, inf, 0 and below-``t_min`` targets, and
predictions exactly at the clip bounds (where ``jnp.clip`` and
``jnp.maximum`` split the gradient half and half).

Tolerance: values rtol 1e-5; gradients the suite's (atol 3e-4 x max|g|,
rtol 2e-3), NaN where JAX has NaN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from priordepth_gaussiansplatting_torch.depth import losses as P
from priordepth_gaussiansplatting_tpu.depth import losses as J

torch.set_num_threads(2)
VAL_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 2e-3
T_MIN, T_MAX = 0.5, 10.0
SHAPE = (2, 9, 11)
K = 8


def maps(seed, case):
    """(pred, target, mask) numpy arrays of SHAPE for a named case."""
    rng = np.random.default_rng(seed)
    pred = (0.2 + 5 * rng.random(SHAPE)).astype(np.float32)
    target = (0.2 + 5 * rng.random(SHAPE)).astype(np.float32)
    mask = rng.random(SHAPE) > 0.3
    if case == "empty":
        mask[:] = False
    elif case == "full":
        mask[:] = True
    elif case == "bounds":
        # Entries exactly at eps and at the trainer's clip bounds.
        pred.reshape(-1)[::7] = 1e-6
        pred.reshape(-1)[1::5] = 0.5
        pred.reshape(-1)[2::6] = 4.0
    elif case == "singular":
        # Sample 0: a constant prediction; sample 1: one masked pixel.
        pred[0] = 1.5
        mask[1] = False
        mask[1, 3, 4] = True
    return pred, target, mask


def check(fn_port, fn_jax, pred, *rest):
    """Value and gradient w.r.t. the first argument."""
    want, want_g = jax.value_and_grad(fn_jax)(jnp.asarray(pred),
                                              *map(jnp.asarray, rest))
    x = torch.from_numpy(pred).requires_grad_(True)
    got = fn_port(x, *map(torch.from_numpy, rest))
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=VAL_RTOL)
    want_g = np.asarray(want_g)
    finite = np.isfinite(want_g)
    scale = float(np.abs(want_g[finite]).max()) if finite.any() else 0.0
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * scale)
    return got_g.numpy()


CASES = ["random", "empty", "full", "bounds", "singular"]


@pytest.mark.parametrize("case", CASES)
def test_silog_matches_jax(case):
    check(P.silog_loss, J.silog_loss, *maps(1, case))


@pytest.mark.parametrize("case", CASES)
def test_grad_l1_matches_jax(case):
    check(P.grad_l1_loss, J.grad_l1_loss, *maps(2, case))


@pytest.mark.parametrize("case", CASES)
def test_scale_and_shift_invariant_matches_jax(case):
    check(P.scale_and_shift_invariant_loss,
          J.scale_and_shift_invariant_loss, *maps(3, case))


@pytest.mark.parametrize("case", ["random", "empty", "singular"])
def test_compute_scale_and_shift_matches_jax(case):
    """(s, t) per sample; the singular samples give (0, 0) and no NaN in
    the gradient of s + t."""
    pred, target, mask = maps(4, case)
    want = J.compute_scale_and_shift(*map(jnp.asarray, (pred, target,
                                                        mask)))
    got = P.compute_scale_and_shift(*map(torch.from_numpy, (pred, target,
                                                            mask)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=VAL_RTOL,
                                   atol=1e-6)
    if case == "singular":
        assert got[0][0].item() == 0.0 and got[1][1].item() == 0.0

    def port(p, t, m):
        s, sh = P.compute_scale_and_shift(p, t, m)
        return torch.sum(s + sh)

    def jaxf(p, t, m):
        s, sh = J.compute_scale_and_shift(p, t, m)
        return jnp.sum(s + sh)
    g = check(port, jaxf, pred, target, mask)
    assert np.isfinite(g).all()


@pytest.mark.parametrize("case", ["random", "bounds"])
def test_trainer_loss_through_the_clip_matches_jax(case):
    """SILog + 0.5 GradL1 of the prediction clipped to [0.5, 4], as the
    trainer's loss (JAX ``trainer.py:104-108``): entries exactly at a
    bound get half the gradient in both."""
    pred, target, mask = maps(5, case)

    def port(p, t, m):
        p = P.clip(p, 0.5, 4.0)
        return P.silog_loss(p, t, m) + 0.5 * P.grad_l1_loss(p, t, m)

    def jaxf(p, t, m):
        p = jnp.clip(p, 0.5, 4.0)
        return J.silog_loss(p, t, m) + 0.5 * J.grad_l1_loss(p, t, m)
    g = check(port, jaxf, pred, target, mask)
    if case == "bounds":
        at = (pred == 0.5) | (pred == 4.0)
        assert at.any() and np.abs(g[at & mask]).max() > 0


def sid_targets(seed):
    """Targets with inf, 0, below t_min, exactly t_min and t_max, above
    t_max and NaN among random depths."""
    rng = np.random.default_rng(seed)
    t = (T_MIN + (T_MAX - T_MIN) * rng.random(SHAPE)).astype(np.float32)
    flat = t.reshape(-1)
    for i, v in enumerate([np.inf, 0.0, 1e-9, 0.3 * T_MIN, T_MIN, T_MAX,
                           3 * T_MAX, -1.0]):
        flat[i * 9:i * 9 + 3] = v
    return t


def test_sid_label_matches_xla_int_cast():
    """inf saturates to the top bin, 0 and sub-t_min targets to bin 0,
    and a NaN ratio becomes 0, as XLA's cast gives."""
    t = sid_targets(6)
    t.reshape(-1)[-1] = np.nan
    for top in (K, K - 1):
        ratio = jnp.log(jnp.maximum(jnp.asarray(t), 1e-6) / T_MIN) \
            / jnp.log(T_MAX / T_MIN)
        want = jnp.clip((ratio * K).astype(jnp.int32), 0, top)
        got = P.sid_label(torch.from_numpy(t), K, top, T_MIN, T_MAX, 1e-6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ordinal_regression_matches_jax():
    rng = np.random.default_rng(7)
    probs = rng.random((2, K) + SHAPE[1:]).astype(np.float32)
    # Entries exactly at the clip bounds eps and 1 - eps.
    probs.reshape(-1)[::11] = np.float32(1e-6)
    probs.reshape(-1)[5::13] = np.float32(1.0) - np.float32(1e-6)
    check(lambda p, t: P.ordinal_regression_loss(p, t, T_MIN, T_MAX),
          lambda p, t: J.ordinal_regression_loss(p, t, T_MIN, T_MAX),
          probs, sid_targets(8))


def test_discrete_nll_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, K) + SHAPE[1:]).astype(np.float32)
    log_probs = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=1))
    check(lambda p, t: P.discrete_nll_loss(p, t, T_MIN, T_MAX),
          lambda p, t: J.discrete_nll_loss(p, t, T_MIN, T_MAX),
          log_probs, sid_targets(10))


def test_helpers_split_ties_as_jax():
    x = np.array([0.25, 0.5, 1.0, 2.0, 3.0, 0.0, -1.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.5, 2.0) * 3.0
                                      + jnp.abs(v - 1.0)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    (P.clip(t, 0.5, 2.0) * 3.0 + P.jax_abs(t - 1.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
