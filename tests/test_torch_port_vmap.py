"""The port's vmap emission (all draws in one forward, the draw axis
written out in the tensors) and the lane axis of its sampled GEMM.

- Kernel algebra against JAX's S-batched Pallas kernels: ``jax.vmap`` of
  ``sampled_matmul_pallas`` over keys dispatches ``_forward_s`` (#8),
  ``_dx_s`` (#9) and ``_dw_s`` (#10) through the custom_vmap rules, in
  interpret mode. An identity probe gives each lane's weight, hence its
  eps; the port's lane algebra on those eps reproduces the kernels'
  outputs and ``jax.vjp``'s gradients. Interpret mode stubs the TPU PRNG
  (tests/test_sampled_matmul.py), so this checks the algebra, not the
  noise. Tolerances 1e-5 forward, 1e-4 backward (f32 sums of 30-70
  products in two orders, eps recovered by a division).
- The port's own contract for ``sampled_matmul_batched``: lane s is draw
  s of the batch sampler, lane 0 the single-draw op, gradients through
  the lanes the sum of per-lane gradients.
- ``mc_forward(emission="vmap")`` on the narrow ResNet twins with the
  same per-draw weights injected into both packages: against JAX's vmap
  emission and against the port's draw loop, in eval and in one training
  step, f32 on the CPU, tolerance 1e-4; with draws made in the layers
  (``presample="off"``), against the seeds each layer drew.
- Errors and cleanup.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_torch_tpu.ops.pallas.sampled_matmul import (
    sampled_matmul_pallas,
    sampled_matmul_pallas_batched,
)
from bayesian_torch_tpu.parallel import mc as jmc
from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.models.dnn_to_bnn import iter_bayesian_layers
from bayesian_torch_tpu_torch.ops import conv as conv_ops
from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from bayesian_torch_tpu_torch.ops.sampling import draw_seed, sigma_from_rho
from bayesian_torch_tpu_torch.parallel import mc as tmc
from tests._torch_port import draw_noise, inject_draws, tiny_twins, to_np

S = 3
B = 2
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _gemm_setup(M=30, N=50, K=70, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(S, M, K).astype(np.float32)
    mu = (0.3 * rs.randn(N, K)).astype(np.float32)
    rho = rs.uniform(-2.0, -0.5, (N, K)).astype(np.float32)
    g = rs.randn(S, M, N).astype(np.float32)
    return x, mu, rho, g


def _lane_eps(keys, mu, rho):
    """Each lane's eps, from its weight through the identity probe."""
    K = mu.shape[1]
    W = np.asarray(jax.vmap(lambda k: sampled_matmul_pallas(
        k, jnp.eye(K), mu, rho, out_dtype=jnp.float32))(keys))
    return (_t(W.transpose(0, 2, 1)) - _t(mu)) / sigma_from_rho(_t(rho))


# ------------------------------------------ against the S-batched kernels


@pytest.mark.parametrize("shared", [False, True])
def test_lane_algebra_matches_jax_batched_kernels(shared):
    """#8 forward, #9 dx per lane, #10 dmu and drho summed over lanes."""
    x, mu, rho, g = _gemm_setup()
    if shared:
        x = x[0]
    keys = jax.random.split(jax.random.key(7), S)
    eps = _lane_eps(keys, mu, rho)
    out_j, vjp = jax.vjp(lambda a, m, r: sampled_matmul_pallas_batched(
        keys, a, m, r, out_dtype=jnp.float32), x, mu, rho)
    dx_j, dmu_j, drho_j = vjp(jnp.asarray(g))

    rho_t = _t(rho).requires_grad_(True)
    sigma = sigma_from_rho(rho_t)
    out_t = kb.matmul_sampled_weight(_t(x), _t(mu), sigma.detach(), eps)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)
    dx_t = kb.matmul_dx(_t(g), _t(mu), sigma.detach(), eps)
    if shared:  # x broadcast over the lanes: its gradient is their sum
        dx_t = dx_t.sum(0)
    dmu_t, dsig_t = kb.matmul_dw(_t(g), _t(x), eps)
    (drho_t,) = torch.autograd.grad(sigma, rho_t, dsig_t)
    for got, want in ((dx_t, dx_j), (dmu_t, dmu_j), (drho_t, drho_j)):
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------- the port's own lane contract


def _posterior(N=13, K=21, seed=1):
    rs = np.random.RandomState(seed)
    mu = _t(0.3 * rs.randn(N, K))
    rho = _t(rs.uniform(-4.0, -1.0, (N, K)))
    return mu, rho


def test_lane_s_is_draw_s_of_the_batch_sampler():
    mu, rho = _posterior()
    x = _t(np.random.RandomState(2).randn(S, 9, 21))
    seed = 2**40 + 17
    launches = kb.sampled_matmul_batched.launches
    out = kb.sampled_matmul_batched(seed, x, mu, rho)
    assert kb.sampled_matmul_batched.launches == launches  # CPU: plain
    assert out.shape == (S, 9, 13) and out.dtype == torch.float32
    w = ka.sample_scaled_normals_batch(seed, mu, sigma_from_rho(rho), S,
                                       torch.float32)
    for s in range(S):
        torch.testing.assert_close(out[s], x[s] @ w[s].T, rtol=1e-6,
                                   atol=1e-5)
    shared = kb.sampled_matmul_batched(seed, x[1], mu, rho, S)
    torch.testing.assert_close(shared[1], out[1], rtol=0, atol=0)
    torch.testing.assert_close(shared[0], x[1] @ w[0].T, rtol=1e-6,
                               atol=1e-5)
    # lane 0 is the single-draw op, bit for bit
    torch.testing.assert_close(out[0], kb.sampled_matmul(seed, x[0], mu, rho),
                               rtol=0, atol=0)
    assert kb.sampled_matmul_batched(seed, x.bfloat16(), mu,
                                     rho).dtype == torch.bfloat16


def test_lane_backward_lane_zero_is_the_single_draw_backward():
    mu, rho = _posterior(seed=3)
    rs = np.random.RandomState(4)
    g, x = _t(rs.randn(S, 9, 13)), _t(rs.randn(S, 9, 21))
    sigma = sigma_from_rho(rho)
    dx = kb.sampled_matmul_dx_batched(5, g, mu, sigma)
    torch.testing.assert_close(dx[0], kb.sampled_matmul_dx(5, g[0], mu, sigma),
                               rtol=0, atol=0)
    dmu, dsig = kb.sampled_matmul_dw_batched(5, g[:1], x[0])
    want = kb.sampled_matmul_dw(5, g[0], x[0])
    torch.testing.assert_close(dmu, want[0], rtol=0, atol=0)
    torch.testing.assert_close(dsig, want[1], rtol=0, atol=0)


@pytest.mark.parametrize("shared", [False, True])
def test_grad_through_lanes_is_the_sum_of_per_lane_grads(shared):
    """As JAX's test_grad_through_vmapped_call: autograd through the lane
    op (K-D and K-E with lanes on the card) equals the sum over lanes of
    autograd through each lane's weight draw."""
    mu, rho = _posterior(seed=5)
    rs = np.random.RandomState(6)
    x = _t(rs.randn(9, 21) if shared else rs.randn(S, 9, 21))
    g = _t(rs.randn(S, 9, 13))
    mu.requires_grad_(True)
    rho.requires_grad_(True)
    x.requires_grad_(True)
    seed = 99
    out = kb.sampled_matmul_batched(seed, x, mu, rho, S)
    assert type(out.grad_fn).__name__ == "_SampledMatmulBackward"
    assert [tuple(t.shape) for t in out.grad_fn.saved_tensors] == [
        tuple(x.shape), (13, 21), (13, 21)]  # residuals x, mu, sigma
    got = torch.autograd.grad(out, (x, mu, rho), g)
    want = [torch.zeros_like(t) for t in (x, mu, rho)]
    for s in range(S):
        w = ka.sample_scaled_normals_batch(seed, mu, sigma_from_rho(rho), S,
                                           torch.float32)[s]
        xs = x if shared else x[s]
        for acc, d in zip(want, torch.autograd.grad(xs @ w.T, (x, mu, rho),
                                                    g[s])):
            acc += d
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_batched_posterior_and_bad_shapes_raise():
    mu, rho = _posterior()
    x = torch.zeros(S, 4, 21)
    with pytest.raises(NotImplementedError, match="posterior ensembles"):
        kb.sampled_matmul_batched(0, x, mu[None].expand(S, -1, -1),
                                  rho[None].expand(S, -1, -1))
    for args in ((x[0], mu, rho), (x, mu, rho, S + 1), (x[..., :-1], mu, rho),
                 (x, mu, rho[:, :-1]), (x[0], mu, rho, 0)):
        with pytest.raises(ValueError):
            kb.sampled_matmul_batched(0, *args)


# ------------------------------------------------- the emission


def _image(seed=2):
    return np.random.RandomState(seed).randn(B, 3, 16, 16).astype(np.float32)


@pytest.mark.parametrize("reduce,return_kl", [(None, True), ("mean", True),
                                              (None, False)])
def test_vmap_emission_matches_jax_vmap_emission(monkeypatch, reduce,
                                                 return_kl):
    jm, tm, _ = tiny_twins(seed=21)
    inject_draws(monkeypatch, draw_noise(tm, S, seed=1))
    x = _image()
    kw = dict(emission="vmap", presample="on", reduce=reduce,
              return_kl=return_kl)
    want = jmc.mc_forward(jm, jnp.asarray(x), S, **kw)
    got = tmc.mc_forward(tm, torch.from_numpy(x), S, **kw)
    if return_kl:
        (want, want_kl), (got, got_kl) = want, got
        assert float(got_kl) == pytest.approx(float(want_kl), rel=1e-6)
    assert got.shape == ((B, 10) if reduce else (S, B, 10))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    for mod in tm.modules():
        assert not hasattr(mod, "_mc_draws")
        assert not hasattr(mod, "_presampled_w")
        assert getattr(mod, "compute_kl", True) is True


def test_vmap_emission_matches_the_loop_in_eval(monkeypatch):
    _, tm, _ = tiny_twins(seed=22)
    inject_draws(monkeypatch, draw_noise(tm, S, seed=2))
    x = torch.from_numpy(_image(3))
    loop, kl_loop = tmc.mc_forward(tm, x, S, presample="on")
    vmap, kl_vmap = tmc.mc_forward(tm, x, S, presample="on", emission="vmap")
    assert not vmap.requires_grad
    torch.testing.assert_close(vmap, loop, **TOL)
    assert float(kl_vmap) == float(kl_loop)
    mean = tmc.mc_forward(tm, x, S, presample="on", emission="vmap",
                          reduce="mean", return_kl=False)
    torch.testing.assert_close(mean, loop.mean(0), **TOL)


def test_vmap_training_step_matches_the_loop(monkeypatch):
    """One ELBO step (presample "on", the same draws): loss, every
    gradient, the BN running statistics after one EMA, the parameters
    after SGD."""
    _, tm, _ = tiny_twins(seed=23)
    tm.train()
    inject_draws(monkeypatch, draw_noise(tm, S, seed=3))
    twin = copy.deepcopy(tm)
    rs = np.random.RandomState(4)
    x = torch.from_numpy(_image(4))
    y = torch.from_numpy(rs.randint(0, 10, B))
    results = []
    for model, emission in ((tm, "auto"), (twin, "vmap")):
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        loss, nll, kl = engine.make_train_step(
            S, B, presample="on", emission=emission)(model, opt, x, y)
        results.append((loss, {n: p.grad for n, p in model.named_parameters()},
                        model.state_dict()))
    (loss_a, grads_a, state_a), (loss_b, grads_b, state_b) = results
    assert float(loss_b) == pytest.approx(float(loss_a), rel=1e-5)
    for name, g in grads_a.items():
        torch.testing.assert_close(grads_b[name], g, **TOL, msg=name)
    for name, v in state_a.items():
        torch.testing.assert_close(state_b[name], v, **TOL, msg=name)
    assert int(twin.bn1.num_batches_tracked) == 1
    assert not twin.bn1.stats_frozen and twin.bn1._mc_stats is None


@pytest.mark.parametrize("training", [False, True])
def test_presample_off_draws_each_layer_in_one_launch(monkeypatch, training):
    """presample="off" (here "auto"), fc.impl="pallas": every conv's S
    kernels are ``sample_gaussian_batch`` on the seed that conv drew, and
    the head's lanes are the plain fused GEMM on its seed plus the bias's
    S draws on the next."""
    _, tm, _ = tiny_twins(seed=24)
    tm.fc.impl = "pallas"
    tm.train(training)
    convs = [m for m in iter_bayesian_layers(tm) if m is not tm.fc]
    called, kernels, fc_in = [], {}, []
    for m in convs:
        m.register_forward_pre_hook(lambda m, a: called.append(m))
    tm.fc.register_forward_pre_hook(lambda m, a: fc_in.append(a[0]))
    real = conv_ops.conv_draws

    def spy(x, w, b=None, **kw):
        kernels[called[-1]] = w.detach()
        return real(x, w, b, **kw)

    monkeypatch.setattr(conv_ops, "conv_draws", spy)
    sampler_calls = []
    real_batch = ka.sample_gaussian_batch
    monkeypatch.setattr(
        ka, "sample_gaussian_batch",
        lambda *a: sampler_calls.append(a[3]) or real_batch(*a))
    state = tm.conv1.generator.get_state()  # one generator for all layers
    out, _ = tmc.mc_forward(tm, torch.from_numpy(_image(5)), S,
                            emission="vmap")
    assert out.shape == (S, B, 10) and out.requires_grad == training
    assert sampler_calls == [S] * (len(convs) + 1)  # + the head's bias
    assert called == convs
    replay = torch.Generator().set_state(state)
    for m in convs:
        want = ka.sample_gaussian_batch(draw_seed(replay), m.mu_kernel,
                                        m.rho_kernel, S, torch.float32)
        torch.testing.assert_close(kernels[m], want.detach(), rtol=0, atol=0)
    fc = tm.fc
    lanes = fc_in[0].detach().reshape(B, S, -1).transpose(0, 1)
    head = kb.sampled_matmul_batched_plain(
        draw_seed(replay), lanes, fc.mu_weight, sigma_from_rho(fc.rho_weight),
        S)
    bias = ka.sample_gaussian_batch(draw_seed(replay), fc.mu_bias,
                                    fc.rho_bias, S, torch.float32)
    torch.testing.assert_close(out.detach(), (head + bias[:, None]).detach(),
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------- errors and cleanup


def test_modules_without_a_draw_axis_raise_and_name_themselves():
    _, tm, _ = tiny_twins(seed=25)
    x = torch.randn(B, 3, 16, 16)
    plain_bn = copy.deepcopy(tm)
    plain_bn.bn1 = torch.nn.BatchNorm2d(16)
    extra = copy.deepcopy(tm)
    extra.layer1[1].extra = torch.nn.Conv2d(32, 32, 1)
    calibrating = copy.deepcopy(tm)
    calibrating.fc.prepare()
    for model, name in ((plain_bn, "'bn1' (BatchNorm2d)"),
                        (extra, "'layer1.1.extra' (Conv2d)"),
                        (calibrating, "'fc' (LinearReparameterization)")):
        with pytest.raises(NotImplementedError, match=re.escape(name)):
            tmc.mc_forward(model, x, S, emission="vmap")
    # a mesh is no module: only a non-mesh object is refused, by its type
    with pytest.raises(TypeError, match="make_mesh"):
        tmc.mc_forward(tm, x, S, emission="vmap", mesh=object())
    # structured=True names the module and falls back to the draw loop
    with pytest.warns(RuntimeWarning, match=re.escape(
            "module 'layer1.1.extra' (Conv2d) cannot take the draw axis")):
        out = tmc.mc_forward(extra, x, S, return_kl=False,
                             structured=True)
    assert out.shape == (S, B, 10)
    # one draw is the plain forward: nothing to check
    out, _ = tmc.mc_forward(plain_bn, x, 1, emission="vmap")
    assert out.shape == (1, B, 10)


@pytest.mark.parametrize("presample", ["on", "off"])
def test_per_call_attributes_are_gone_after_a_failing_forward(presample):
    _, tm, _ = tiny_twins(seed=26)
    tm.train()
    with pytest.raises(ValueError, match="channels"):
        tmc.mc_forward(tm, torch.randn(B, 5, 16, 16), S, emission="vmap",
                       presample=presample)
    for mod in tm.modules():
        assert not hasattr(mod, "_mc_draws")
        assert not hasattr(mod, "_presampled_w")
        assert getattr(mod, "compute_kl", True) is True
        assert getattr(mod, "stats_frozen", False) is False
        assert getattr(mod, "_mc_stats", None) is None
    assert int(tm.bn1.num_batches_tracked) == 0
    out, _ = tmc.mc_forward(tm, torch.randn(B, 3, 16, 16), S)
    assert out.shape == (S, B, 10)
