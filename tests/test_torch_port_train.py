"""The port's ELBO training step against the JAX package's vmap path, on
the narrow ResNet twins in training mode with S = 3 draws, through the
port's draw loop and its vmap emission.

Both packages' presample hooks are replaced by a differentiable
``mu + softplus(rho) * eps`` on the same numpy eps
(``tests/_torch_port.py::inject_draws``), so the two steps see the same
weights. Compared after one step of ``SGD(lr, momentum=0.9)``: the loss,
every parameter's gradient, the BN running statistics and
``num_batches_tracked``, and every parameter. f32 on the CPU, tolerance
1e-4 (as the other port parity tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from bayesian_torch_tpu.parallel import mc as jmc
from bayesian_torch_tpu.utils.checkpoint import _torch_key_for
from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.models.dnn_to_bnn import iter_bayesian_layers
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from bayesian_torch_tpu_torch.parallel import mc as tmc
from tests._torch_port import (draw_noise, inject_draws, jax_arrays,
                               set_jax_eval, tiny_twins, to_np)

S = 3
B = 4
LR = 0.05
TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 3, 16, 16).astype(np.float32)
    y = rs.randint(0, 10, B).astype(np.int32)
    return x, y


def _jax_step(jm, x, y, bn_stats):
    """The JAX engine's ELBO step (``make_train_step``), on the vmapped
    emission with the presample hook; returns (loss, {key: grad})."""

    def loss_fn(model):
        outs, kl = jmc.mc_forward(model, x, S, presample="on",
                                  emission="vmap", bn_stats=bn_stats)
        log_probs = jax.nn.log_softmax(outs, axis=-1)
        nll = -jnp.take_along_axis(log_probs.mean(axis=0), y[:, None],
                                   axis=1).mean()
        return nll + kl / B, (nll, kl)

    (loss, _), grads = nnx.value_and_grad(loss_fn, has_aux=True)(jm)
    optimizer = nnx.Optimizer(jm, optax.sgd(LR, 0.9), wrt=nnx.Param)
    optimizer.update(jm, grads)
    return float(loss), {_torch_key_for(path): np.asarray(v[...])
                         for path, v in nnx.to_flat_state(grads)}


def _twins_in_training(seed, momentum=0.1, rho=None):
    jm, tm, _ = tiny_twins(seed=seed, rho=rho)
    set_jax_eval(jm, training=True)
    tm.train()
    for _, mod in nnx.iter_modules(jm):
        if hasattr(mod, "momentum"):
            mod.momentum = momentum
    for mod in tm.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.momentum = momentum
    return jm, tm


@pytest.mark.parametrize("emission", ["auto", "vmap", "scan"])
@pytest.mark.parametrize("bn_stats,momentum", [("ema", 0.1), ("ema", None),
                                               ("freeze", 0.1)])
def test_elbo_step_matches_jax_vmap_path(monkeypatch, bn_stats, momentum,
                                         emission):
    _check_step(monkeypatch, bn_stats, momentum, emission)


def test_elbo_step_through_the_pointwise_emission_matches_jax(monkeypatch):
    """With ``CONV_1X1_DOT = True`` (set in both packages) every 1x1
    stride-1 conv of the narrow ResNet trains through the per-draw GEMM's
    wrapper, forward and input gradient (its plain version on the CPU);
    one vmap ELBO step equals the JAX step."""
    from bayesian_torch_tpu.ops import conv as jconv
    from bayesian_torch_tpu_torch.ops import conv as tconv
    from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

    monkeypatch.setattr(jconv, "CONV_1X1_DOT", True)
    monkeypatch.setattr(tconv, "CONV_1X1_DOT", True)
    calls = []
    real = kg._apply
    monkeypatch.setattr(kg, "_apply",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    tm = _check_step(monkeypatch, "ema", 0.1, "vmap")
    sites = sum(tconv._is_pointwise(m.mu_kernel, m.stride, m.padding,
                                    m.dilation, m.groups, None)
                for m in tm.modules() if hasattr(m, "mu_kernel"))
    assert sites == 4 and len(calls) == 2 * sites  # forward and dx


def _check_step(monkeypatch, bn_stats, momentum, emission):
    """One ELBO step of the port through ``emission`` against the JAX
    vmap step on the same injected draws; returns the torch model."""
    jm, tm = _twins_in_training(seed=11, momentum=momentum)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    inject_draws(monkeypatch, draw_noise(tm, S))
    x, y = _batch()
    want_loss, want_grads = _jax_step(jm, jnp.asarray(x), jnp.asarray(y),
                                      bn_stats)

    step = engine.make_train_step(S, B, presample="on", emission=emission)
    opt = torch.optim.SGD(tm.parameters(), lr=LR, momentum=0.9)
    if bn_stats == "freeze":
        real = tmc.mc_forward
        monkeypatch.setattr(engine, "mc_forward",
                            lambda *a, **k: real(*a, bn_stats="freeze", **k))
    loss, nll, kl = step(tm, opt, torch.from_numpy(x), torch.from_numpy(y))

    assert float(loss) == pytest.approx(want_loss, rel=1e-4, abs=1e-4)
    assert float(loss) == pytest.approx(float(nll + kl / B), rel=1e-6)
    grads = {name: p.grad for name, p in tm.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(to_np(g), want_grads[name], **TOL,
                                   err_msg=name)
    after_j, after_t = jax_arrays(jm), tm.state_dict()
    assert set(after_j) == set(after_t)
    for name, v in after_t.items():
        np.testing.assert_allclose(to_np(v), after_j[name], **TOL,
                                   err_msg=name)
    tracked = [k for k in after_t if k.endswith("num_batches_tracked")]
    moved = [k for k in after_t if k.endswith(("running_mean", "running_var"))
             and not torch.equal(after_t[k], before[k])]
    if bn_stats == "ema":
        assert all(int(after_t[k]) == 1 for k in tracked)
        assert len(moved) == 2 * len(tracked)
    else:
        assert all(int(after_t[k]) == 0 for k in tracked) and not moved
    for mod in tm.modules():
        assert getattr(mod, "stats_frozen", False) is False
        assert getattr(mod, "_mc_stats", None) is None
        assert not hasattr(mod, "_mc_draws")
    return tm


def test_one_draw_updates_bn_as_the_plain_forward_does():
    """num_mc = 1 is the plain forward with torch's own BN update, as the
    JAX ``_mc_forward_inner`` runs ``model(x)``; rho = -30 makes every
    draw the posterior mean in both packages."""
    jm, tm = _twins_in_training(seed=12, rho=-30.0)
    x, _ = _batch(3)
    want, want_kl = jmc.mc_forward(jm, jnp.asarray(x), 1)
    got, kl = tmc.mc_forward(tm, torch.from_numpy(x), 1)
    assert got.requires_grad and got.shape == (1, B, 10)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert float(kl.detach()) == pytest.approx(float(want_kl), rel=1e-5)
    after_j, after_t = jax_arrays(jm), tm.state_dict()
    for name, v in after_t.items():
        np.testing.assert_allclose(to_np(v), after_j[name], **TOL,
                                   err_msg=name)
    assert int(tm.bn1.num_batches_tracked) == 1


def test_presample_training_step_uses_one_sampler_and_one_dsigma(monkeypatch):
    """presample="on" in training differentiates through the batch
    sampler: one sampler call for the flat buffer of every layer and one
    regenerate-eps backward for all of it; the split back into layers
    hands every layer its own gradient."""
    _, tm = _twins_in_training(seed=13)
    calls = {"fwd": 0, "dsigma": 0}
    real_fwd, real_dsigma = tmc.sample_scaled_normals_batch, ka.dsigma

    def fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    def dsigma(seed, g):
        calls["dsigma"] += 1
        return real_dsigma(seed, g)

    monkeypatch.setattr(tmc, "sample_scaled_normals_batch", fwd)
    monkeypatch.setattr(ka, "dsigma", dsigma)
    x, y = _batch(4)
    opt = torch.optim.SGD(tm.parameters(), lr=LR, momentum=0.9)
    loss, _, _ = engine.make_train_step(S, B, presample="on")(
        tm, opt, torch.from_numpy(x), torch.from_numpy(y))
    assert calls == {"fwd": 1, "dsigma": 1}
    assert np.isfinite(float(loss))
    for name, p in tm.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        if "mu_" in name or "rho_" in name:
            assert bool(p.grad.abs().sum() > 0), name
    assert int(tm.bn1.num_batches_tracked) == 1


def test_presample_auto_is_off_in_training_and_kl_enters_once(monkeypatch):
    """Training resolves presample "auto" to "off" (draws inside the
    layers); the KL is evaluated in one draw only, and its gradient is
    the KL's own."""
    _, tm = _twins_in_training(seed=14, rho=-30.0)
    calls = []
    monkeypatch.setattr(tmc, "_presample_layers",
                        lambda m, n: calls.append(n) or [])
    evaluated = []
    for layer in iter_bayesian_layers(tm):
        real = layer.kl_loss
        monkeypatch.setattr(layer, "kl_loss",
                            lambda real=real: evaluated.append(1) or real())
    x = torch.from_numpy(_batch(5)[0])
    _, kl = tmc.mc_forward(tm, x, S)
    assert calls == []
    n_layers = len(list(iter_bayesian_layers(tm)))
    assert len(evaluated) == n_layers
    (g,) = torch.autograd.grad(kl, tm.conv1.mu_kernel)
    evaluated.clear()
    (want,) = torch.autograd.grad(tm.conv1.kl_loss(), tm.conv1.mu_kernel)
    torch.testing.assert_close(g, want)
    assert all(layer.compute_kl for layer in iter_bayesian_layers(tm))
