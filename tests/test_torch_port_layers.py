"""Port layers against the JAX layers on the same weights (moved with
``load_jax_state``) and the same injected noise. f32 on the CPU; the
tolerance is 1e-5 (two convolution / GEMM libraries sum in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import bayesian_torch_tpu.layers as jl
from bayesian_torch_tpu.layers.base_variational_layer import Presampled
import bayesian_torch_tpu_torch.layers as tl
from bayesian_torch_tpu_torch.nn import Sequential
from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
from tests._torch_port import jax_arrays, random_state, set_jax_eval, to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _twin(jax_cls, torch_cls, *args, seed=0, **kw):
    jm = jax_cls(*args, rngs=nnx.Rngs(seed), **kw)
    arrays = random_state(jax_arrays(jm), seed=seed)
    from bayesian_torch_tpu.utils.checkpoint import import_torch_state_dict
    import_torch_state_dict(jm, arrays)
    tm = torch_cls(*args, **kw)
    load_jax_state(tm, arrays)
    return jm, tm, arrays


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


CONV_CASES = [
    dict(stride=1, padding=0, bias=True),
    dict(stride=2, padding=1, bias=True),
    dict(stride=2, padding=1, bias=False),
    dict(stride=1, padding=2, bias=False, dilation=2),
]


@pytest.mark.parametrize("kw", CONV_CASES)
def test_conv2d_forward_and_kl_match_jax(kw):
    jm, tm, _ = _twin(jl.Conv2dReparameterization,
                      tl.Conv2dReparameterization, 4, 6, 3, **kw)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 4, 9, 9).astype(np.float32)
    eps_k = rs.randn(6, 4, 3, 3).astype(np.float32)
    eps_b = rs.randn(6).astype(np.float32) if kw["bias"] else None
    jo, jk = jm(jnp.asarray(x), eps_k=eps_k, eps_b=eps_b)
    to, tk = tm(_t(x), eps_k=_t(eps_k),
                eps_b=None if eps_b is None else _t(eps_b))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    assert tk.item() == pytest.approx(float(jk), rel=1e-6)


@pytest.mark.parametrize("cls,shape", [("Conv1d", (2, 4, 11)),
                                       ("Conv3d", (1, 4, 5, 6, 5))])
def test_conv1d_conv3d_match_jax(cls, shape):
    name = cls + "Reparameterization"
    jm, tm, _ = _twin(getattr(jl, name), getattr(tl, name), 4, 3, 3,
                      padding=1)
    rs = np.random.RandomState(2)
    x = rs.randn(*shape).astype(np.float32)
    eps_k = rs.randn(*tm.mu_kernel.shape).astype(np.float32)
    eps_b = rs.randn(3).astype(np.float32)
    jo, _ = jm(jnp.asarray(x), eps_k=eps_k, eps_b=eps_b)
    to, _ = tm(_t(x), eps_k=_t(eps_k), eps_b=_t(eps_b))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)


@pytest.mark.parametrize("lead", [(3,), (2, 3, 4)])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_forward_and_kl_match_jax(lead, bias):
    jm, tm, _ = _twin(jl.LinearReparameterization,
                      tl.LinearReparameterization, 7, 5, bias=bias)
    rs = np.random.RandomState(3)
    x = rs.randn(*lead, 7).astype(np.float32)
    eps_w = rs.randn(5, 7).astype(np.float32)
    eps_b = rs.randn(5).astype(np.float32) if bias else None
    jo, jk = jm(jnp.asarray(x), eps_w=eps_w, eps_b=eps_b)
    to, tk = tm(_t(x), eps_w=_t(eps_w),
                eps_b=None if eps_b is None else _t(eps_b))
    assert to.shape == lead + (5,)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    assert tk.item() == pytest.approx(float(jk), rel=1e-6)


def test_dnn_to_bnn_flag_bare_output():
    jm, tm, _ = _twin(jl.Conv2dReparameterization,
                      tl.Conv2dReparameterization, 3, 2, 1)
    jm.dnn_to_bnn_flag = True
    tm.dnn_to_bnn_flag = True
    rs = np.random.RandomState(4)
    x = rs.randn(1, 3, 4, 4).astype(np.float32)
    eps = rs.randn(2, 3, 1, 1).astype(np.float32)
    eps_b = rs.randn(2).astype(np.float32)
    jo = jm(jnp.asarray(x), eps_k=eps, eps_b=eps_b)
    to = tm(_t(x), eps_k=_t(eps), eps_b=_t(eps_b))
    assert isinstance(to, torch.Tensor)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    lin = tl.LinearReparameterization(3, 2)
    lin.dnn_to_bnn_flag = True
    assert isinstance(lin(torch.ones(1, 3)), torch.Tensor)


def test_presampled_branch_matches_jax():
    """An injected per-draw weight (the mc_forward path) replaces the
    posterior in both packages."""
    rs = np.random.RandomState(5)
    jc, tc, _ = _twin(jl.Conv2dReparameterization,
                      tl.Conv2dReparameterization, 3, 4, 3, padding=1)
    jlin, tlin, _ = _twin(jl.LinearReparameterization,
                          tl.LinearReparameterization, 6, 2)
    for jm, tm, wshape, bshape in ((jc, tc, (4, 3, 3, 3), (4,)),
                                   (jlin, tlin, (2, 6), (2,))):
        w = rs.randn(*wshape).astype(np.float32)
        b = rs.randn(*bshape).astype(np.float32)
        jm._presampled_w = Presampled(jnp.asarray(w))
        jm._presampled_b = Presampled(jnp.asarray(b))
        tm._presampled_w, tm._presampled_b = _t(w), _t(b)
    x = rs.randn(2, 3, 5, 5).astype(np.float32)
    np.testing.assert_allclose(to_np(tc(_t(x))[0]),
                               np.asarray(jc(jnp.asarray(x))[0]), **TOL)
    h = rs.randn(4, 6).astype(np.float32)
    np.testing.assert_allclose(to_np(tlin(_t(h))[0]),
                               np.asarray(jlin(jnp.asarray(h))[0]), **TOL)


def test_pallas_impl_runs_fused_gemm_algebra_on_cpu():
    """impl='pallas' (the JAX value) takes the fused-GEMM path: on CPU its
    plain version, x @ (mu + sigma * eps(seed))^T plus a sampled bias."""
    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
    from bayesian_torch_tpu_torch.ops.sampling import (draw_seed,
                                                       sigma_from_rho)

    lin = tl.LinearReparameterization(
        8, 3, impl="pallas", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(1))
    g = torch.Generator()
    g.set_state(lin.generator.get_state())  # replays the forward's seeds
    out, _ = lin(x)
    w = ka.sample_scaled_normals_batch(
        draw_seed(g), lin.mu_weight.detach(),
        sigma_from_rho(lin.rho_weight.detach()), 1, torch.float32)[0]
    b = ka.sample_scaled_normals_batch(
        draw_seed(g), lin.mu_bias.detach(),
        sigma_from_rho(lin.rho_bias.detach()), 1, torch.float32)[0]
    torch.testing.assert_close(out, x @ w.T + b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tl.LinearReparameterization(2, 2, impl="triton")


def test_state_dict_keys_and_priors():
    conv = tl.Conv2dReparameterization(3, 4, 3, bias=False)
    lin = tl.LinearReparameterization(3, 4)
    assert set(conv.state_dict()) == {"mu_kernel", "rho_kernel"}
    assert set(lin.state_dict()) == {"mu_weight", "rho_weight", "mu_bias",
                                     "rho_bias"}
    # priors: non-persistent buffers, prior_variance used as sigma
    assert float(lin.prior_weight_sigma) == 1.0
    assert lin.prior_bias_mu is not None and conv.prior_bias_mu is None
    jm = jl.LinearReparameterization(3, 4, rngs=nnx.Rngs(0))
    assert set(jax_arrays(jm)) == set(lin.state_dict())


def test_init_distribution_and_default_generator():
    tl.seed_default_generator(5)
    a = tl.Conv2dReparameterization(8, 16, 3, posterior_rho_init=-4.0)
    tl.seed_default_generator(5)
    b = tl.Conv2dReparameterization(8, 16, 3, posterior_rho_init=-4.0)
    torch.testing.assert_close(a.mu_kernel, b.mu_kernel, rtol=0, atol=0)
    c = tl.Conv2dReparameterization(8, 16, 3)  # next seed of the counter
    assert not torch.equal(b.mu_kernel, c.mu_kernel)
    rho = a.rho_kernel.detach()
    assert abs(rho.mean().item() + 4.0) < 0.02
    assert abs(rho.std().item() - 0.1) < 0.01
    assert abs(a.mu_kernel.detach().std().item() - 0.1) < 0.01


def test_layers_sample_fresh_noise_each_call():
    lin = tl.LinearReparameterization(
        16, 8, posterior_rho_init=-1.0,
        generator=torch.Generator().manual_seed(0))
    x = torch.ones(1, 16)
    a, kl_a = lin(x)
    b, kl_b = lin(x)
    assert not torch.equal(a, b)
    assert kl_a.item() == kl_b.item()
    lin.compute_kl = False
    assert lin(x)[1] == 0.0


def test_batchnorm_layer_tuple_convention_matches_jax():
    jbn = jl.BatchNorm2dLayer(5)
    arrays = random_state(jax_arrays(jbn), seed=6)
    from bayesian_torch_tpu.utils.checkpoint import import_torch_state_dict
    import_torch_state_dict(jbn, arrays)
    set_jax_eval(jbn)
    tbn = tl.BatchNorm2dLayer(5)
    load_jax_state(tbn, arrays)
    tbn.eval()
    x = np.random.RandomState(7).randn(2, 5, 3, 3).astype(np.float32)
    jo, jz = jbn((jnp.asarray(x), 0.5))
    to, tz = tbn((_t(x), 0.5))
    assert tz == 0 == jz
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(to_np(tbn(_t(x))), np.asarray(jo), **TOL)
    # reference init with a generator: weight ~ U(0, 1)
    g = tl.BatchNorm2dLayer(64, generator=torch.Generator().manual_seed(0))
    assert 0.0 <= g.weight.min() and g.weight.max() <= 1.0
    assert torch.equal(tl.BatchNorm2dLayer(4).weight, torch.ones(4))


def test_relu_dropout_sequential_thread_kl():
    x = torch.tensor([[-1.0, 2.0]])
    out, kl = tl.ReLU()((x, 3.0))
    assert kl == 0 and torch.equal(out, torch.tensor([[0.0, 2.0]]))
    drop = tl.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    y, kl = drop((torch.ones(4, 100), 1.0))
    assert kl == 0 and set(y.unique().tolist()) <= {0.0, 2.0}
    drop.eval()
    assert torch.equal(drop(torch.ones(3)), torch.ones(3))
    with pytest.raises(ValueError):
        tl.Dropout(1.5)
    conv = tl.Conv2dReparameterization(2, 3, 1, bias=False)
    seq = Sequential(conv, tl.BatchNorm2dLayer(3).eval())
    out, kl = seq(torch.ones(1, 2, 2, 2))
    assert out.shape == (1, 3, 2, 2)
    assert kl.item() == pytest.approx(conv.kl_loss().item())
