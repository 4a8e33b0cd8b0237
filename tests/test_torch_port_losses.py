"""The port's uncertainty calibration losses (``utils/avuc_loss.py``,
``utils/uncertainty_calibration_loss.py``) against the JAX package on
seeded logits: each loss's value and its gradient (``torch.autograd``
against ``jax.grad``) to 1e-5; the numpy metrics ``eval_avu`` and
``accuracy_vs_uncertainty`` and the hard-count AvU equal exactly, and
``auc`` within one f32 rounding (2^-23 relative: the two libraries sum
the 20 trapezoids in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_torch_tpu.utils import avuc_loss as javuc
from bayesian_torch_tpu.utils import uncertainty_calibration_loss as jucl
from bayesian_torch_tpu_torch.utils import avuc_loss as tavuc
from bayesian_torch_tpu_torch.utils import uncertainty_calibration_loss as tucl

TOL = dict(rtol=1e-5, atol=1e-5)
N, C = 24, 5


def _batch(seed=0):
    """Logits with about half the labels right, and the labels."""
    rs = np.random.RandomState(seed)
    logits = (2.0 * rs.randn(N, C)).astype(np.float32)
    labels = rs.randint(0, C, N)
    right = rs.rand(N) < 0.5
    labels[right] = logits[right].argmax(1)
    return logits, labels.astype(np.int32)


def _median_entropy(logits):
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    return float(np.median(-(p * np.log(p + 1e-10)).sum(1)))


def _grad_pair(torch_fn, jax_fn, *arrays):
    """(value, grads) of a scalar loss in both packages, the gradient
    taken with respect to every array argument."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = torch_fn(*ts)
    got.backward()
    want, jgrads = jax.value_and_grad(
        jax_fn, argnums=tuple(range(len(arrays))))(
            *[jnp.asarray(a) for a in arrays])
    return (got.item(), [t.grad.numpy() for t in ts],
            float(want), [np.asarray(g) for g in jgrads])


def _check(torch_fn, jax_fn, *arrays):
    got, tgrads, want, jgrads = _grad_pair(torch_fn, jax_fn, *arrays)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, **TOL)
    for g, w in zip(tgrads, jgrads):
        assert np.abs(w).max() > 0  # the loss reaches the argument
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kind", [0, 1])
def test_avu_loss_and_gradient_match_jax(kind):
    logits, labels = _batch(1)
    th = _median_entropy(logits) if kind == 0 else 0.0
    tl, jl = tavuc.AvULoss(beta=2), javuc.AvULoss(beta=2)
    _check(lambda z: tl(z, torch.from_numpy(labels), th, type=kind),
           lambda z: jl(z, jnp.asarray(labels), th, type=kind), logits)


@pytest.mark.parametrize("kind", [0, 1])
def test_auavu_loss_and_gradient_match_jax(kind):
    logits, labels = _batch(2)
    tl, jl = tavuc.AUAvULoss(beta=1), javuc.AUAvULoss(beta=1)
    _check(lambda z: tl(z, torch.from_numpy(labels), type=kind)[0],
           lambda z: jl(z, jnp.asarray(labels), type=kind)[0], logits)
    _, got = tl(torch.from_numpy(logits), torch.from_numpy(labels),
                type=kind)
    _, want = jl(jnp.asarray(logits), jnp.asarray(labels), type=kind)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    assert 0.0 < got.item() <= 1.0


def test_auavu_on_bf16_logits_is_f32_and_matches_jax():
    """bf16 logits: ``auc_avu`` comes back in f32, as JAX's does (its 21
    thresholds are f32), and within 2e-2 relative of JAX's. The two sum
    the soft counts in bf16 in other orders; 128 terms of about 1 each
    carry a bf16 rounding of 2^-8 per partial sum, and the trapezoid's
    ratio of those sums moves by up to about 1 %."""
    rng = np.random.default_rng(0)
    tl, jl = tavuc.AUAvULoss(), javuc.AUAvULoss()
    for _ in range(20):
        logits = (3.0 * rng.normal(size=(128, 10))).astype(np.float32)
        labels = rng.integers(0, 10, 128).astype(np.int32)
        t_logits = torch.from_numpy(logits).bfloat16()
        loss, got = tl(t_logits, torch.from_numpy(labels))
        _, want = jl(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
        assert want.dtype == jnp.float32
        assert got.dtype == torch.float32 and loss.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=2e-2)


def test_avu_uncertainty_helpers_match_jax():
    rs = np.random.RandomState(3)
    mc = rs.dirichlet(np.ones(C), size=(4, N)).astype(np.float32)
    tl, jl = tavuc.AvULoss(), javuc.AvULoss()
    for name in ("entropy", "expected_entropy", "predictive_uncertainty",
                 "model_uncertainty"):
        np.testing.assert_allclose(
            getattr(tl, name)(torch.from_numpy(mc)).numpy(),
            np.asarray(getattr(jl, name)(jnp.asarray(mc))), **TOL,
            err_msg=name)
    pred, true = rs.randint(0, C, N), rs.randint(0, C, N)
    unc = rs.rand(N).astype(np.float32)
    got = tl.accuracy_vs_uncertainty(torch.from_numpy(pred),
                                     torch.from_numpy(true),
                                     torch.from_numpy(unc), 0.5)
    want = jl.accuracy_vs_uncertainty(jnp.asarray(pred), jnp.asarray(true),
                                      jnp.asarray(unc), 0.5)
    assert got.item() == float(want)


def test_error_aligned_losses_and_gradients_match_jax():
    rs = np.random.RandomState(4)
    error = rs.rand(N).astype(np.float32)
    unc = rs.rand(N).astype(np.float32)
    conf = rs.rand(N).astype(np.float32)
    for beta in (1, 3):
        teau, jeau = tucl.EaULoss(beta), jucl.EaULoss(beta)
        _check(lambda e, u: teau(e, u, 0.5, 0.4),
               lambda e, u: jeau(e, u, 0.5, 0.4), error, unc)
        teac, jeac = tucl.EaCLoss(beta), jucl.EaCLoss(beta)
        _check(lambda e, c: teac(e, c, 0.5, 0.6),
               lambda e, c: jeac(e, c, 0.5, 0.6), error, conf)


def test_vectorised_avu_loss_matches_jax():
    logits, labels = _batch(5)
    th = _median_entropy(logits)
    tl, jl = tucl.AvULoss(beta=1), jucl.AvULoss(beta=1)
    _check(lambda z: tl(z, torch.from_numpy(labels), th),
           lambda z: jl(z, jnp.asarray(labels), th), logits)
    # the same soft counts as the per-threshold AvU of avuc_loss
    np.testing.assert_allclose(
        tl(torch.from_numpy(logits), torch.from_numpy(labels), th).item(),
        tavuc.AvULoss()(torch.from_numpy(logits), torch.from_numpy(labels),
                        th).item(), **TOL)


def test_auc_and_numpy_metrics_equal_jax():
    rs = np.random.RandomState(6)
    x = np.sort(rs.rand(21)).astype(np.float32)
    y = rs.rand(21).astype(np.float32)
    for xs, ys in ((x, y), (x[::-1].copy(), y[::-1].copy())):
        got = tavuc.auc(torch.from_numpy(xs), torch.from_numpy(ys))
        want = float(javuc.auc(jnp.asarray(xs), jnp.asarray(ys)))
        np.testing.assert_allclose(got.item(), want, rtol=2**-23, atol=0)
        assert got.item() > 0
    pred, true = rs.randint(0, C, 50), rs.randint(0, C, 50)
    unc = rs.rand(50)
    for a, b in zip(tavuc.eval_avu(pred, true, unc),
                    javuc.eval_avu(pred, true, unc)):
        np.testing.assert_array_equal(a, b)
    for th in (0.1, 0.5, 0.9):
        assert tavuc.accuracy_vs_uncertainty(pred, true, unc, th) == \
            javuc.accuracy_vs_uncertainty(pred, true, unc, th)
    mc = rs.dirichlet(np.ones(C), size=(4, 10))
    for name in ("entropy", "predictive_entropy", "mutual_information"):
        np.testing.assert_array_equal(getattr(tavuc, name)(mc),
                                      getattr(javuc, name)(mc))
