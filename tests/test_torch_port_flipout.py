"""The port's Flipout estimator against the JAX package.

Ops and layers are compared element by element on the same weights
(carried by ``load_jax_state``) and the same injected noise (``eps``,
``sign_in``, ``sign_out`` from numpy seeds): f32 on the CPU at 1e-5, bf16
``compute_dtype`` within one bf16 ulp of the largest value. The JAX
presampled branch draws its signs with ``jax.random.rademacher`` (the port
with the counter hash), so that branch is compared with a zero
perturbation and by its moments. Model level: a narrow Flipout ResNet
against its JAX twin at rho = -30 (the perturbation vanishes, so the noise
streams do not matter), the port's loop against its vmap emission lane for
lane under the same seeds, one MC-2 ELBO step against JAX at 1e-4, and the
Flipout trainer for one tiny epoch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import bayesian_torch_tpu.layers as jl
import bayesian_torch_tpu_torch.layers as tl
from bayesian_torch_tpu.layers.base_variational_layer import Presampled
from bayesian_torch_tpu.ops import conv as jconv
from bayesian_torch_tpu.ops import linear as jlinear
from bayesian_torch_tpu.parallel import mc as jmc
from bayesian_torch_tpu.utils.checkpoint import (_torch_key_for,
                                                 import_torch_state_dict)
from bayesian_torch_tpu_torch.examples import _data as tdata
from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples import (main_bayesian_flipout_imagenet
                                               as flipout_trainer)
from bayesian_torch_tpu_torch.examples import main_bayesian_imagenet as trainer
from bayesian_torch_tpu_torch.models.dnn_to_bnn import iter_bayesian_layers
from bayesian_torch_tpu_torch.ops import conv as tconv
from bayesian_torch_tpu_torch.ops import linear as tlinear
from bayesian_torch_tpu_torch.ops import sampling as ts
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
from tests._torch_port import (FLIPOUT, jax_arrays, random_state,
                               set_jax_eval, tiny_twins, to_np)

TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.key(0)  # unused by the JAX ops once all noise is injected


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(
        np.asarray(a, dtype=np.float32)).to(dtype)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _signs(rs, shape):
    return rs.choice([-1.0, 1.0], size=shape).astype(np.float32)


def _bf16_ulp_of_max(want):
    return float(2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))


def _linear_case(rs, lead, bias, n_in=7, n_out=5):
    return dict(
        x=rs.randn(*lead, n_in).astype(np.float32),
        mu=rs.normal(0, 0.3, (n_out, n_in)).astype(np.float32),
        rho=rs.normal(-2, 0.5, (n_out, n_in)).astype(np.float32),
        mu_b=rs.normal(0, 0.3, n_out).astype(np.float32) if bias else None,
        rho_b=rs.normal(-2, 0.5, n_out).astype(np.float32) if bias else None,
        eps=rs.randn(n_out, n_in).astype(np.float32),
        eps_b=rs.randn(n_out).astype(np.float32) if bias else None,
        sign_in=_signs(rs, lead + (n_in,)),
        sign_out=_signs(rs, lead + (n_out,)))


def _in_dtype(c, jdtype, tdtype):
    """The injected signs in the compute dtype, as uninjected ones are."""
    if jdtype is None:
        return [_j(c["sign_in"]), _j(c["sign_out"])], \
            [_t(c["sign_in"]), _t(c["sign_out"])]
    return [_j(c[k]).astype(jdtype) for k in ("sign_in", "sign_out")], \
        [_t(c[k], tdtype) for k in ("sign_in", "sign_out")]


def _both_linear(c, jdtype=None, tdtype=None):
    jsign, tsign = _in_dtype(c, jdtype, tdtype)
    want = jlinear.flipout_linear(
        _j(c["x"]), KEY, _j(c["mu"]), _j(c["rho"]), _j(c["mu_b"]),
        _j(c["rho_b"]), eps_w=_j(c["eps"]), eps_b=_j(c["eps_b"]),
        sign_in=jsign[0], sign_out=jsign[1], compute_dtype=jdtype)
    got = tlinear.flipout_linear(
        _t(c["x"]), None, _t(c["mu"]), _t(c["rho"]), _t(c["mu_b"]),
        _t(c["rho_b"]), eps_w=_t(c["eps"]), eps_b=_t(c["eps_b"]),
        sign_in=tsign[0], sign_out=tsign[1], compute_dtype=tdtype)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("bias", [True, False])
def test_flipout_linear_matches_jax(lead, bias):
    got, want = _both_linear(_linear_case(np.random.RandomState(0), lead,
                                          bias))
    assert got.shape == lead + (5,)
    np.testing.assert_allclose(to_np(got), want, **TOL)


def test_flipout_linear_bf16_compute_dtype():
    c = _linear_case(np.random.RandomState(1), (4,), True)
    got, want = _both_linear(c, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # sigma, delta, two products and the combine each round to bf16
    assert np.abs(to_np(got) - want).max() <= _bf16_ulp_of_max(want)


CONV_CASES = [
    dict(stride=1, padding=0, bias=True),
    dict(stride=2, padding=1, bias=True),
    dict(stride=1, padding=1, bias=False, groups=2),
    dict(stride=1, padding=2, bias=False, dilation=2),
]


def _conv_case(rs, kw, cin=4, cout=6, k=3, sp=(9, 9), batch=2):
    kw = dict(kw)
    bias = kw.pop("bias")
    groups = kw.get("groups", 1)
    kshape = (cout, cin // groups) + (k,) * len(sp)
    x = rs.randn(batch, cin, *sp).astype(np.float32)
    out_shape = tconv.conv_nd(_t(x), torch.zeros(kshape), **kw).shape
    return kw, dict(
        x=x, mu=rs.normal(0, 0.3, kshape).astype(np.float32),
        rho=rs.normal(-2, 0.5, kshape).astype(np.float32),
        mu_b=rs.normal(0, 0.3, cout).astype(np.float32) if bias else None,
        rho_b=rs.normal(-2, 0.5, cout).astype(np.float32) if bias else None,
        eps=rs.randn(*kshape).astype(np.float32),
        eps_b=rs.randn(cout).astype(np.float32) if bias else None,
        sign_in=_signs(rs, x.shape), sign_out=_signs(rs, tuple(out_shape)))


def _both_conv(kw, c, mode, jdtype=None, tdtype=None):
    jsign, tsign = _in_dtype(c, jdtype, tdtype)
    want = jconv.flipout_conv(
        _j(c["x"]), KEY, _j(c["mu"]), _j(c["rho"]), _j(c["mu_b"]),
        _j(c["rho_b"]), eps_k=_j(c["eps"]), eps_b=_j(c["eps_b"]),
        sign_in=jsign[0], sign_out=jsign[1], mode=mode,
        compute_dtype=jdtype, **kw)
    got = tconv.flipout_conv(
        _t(c["x"]), None, _t(c["mu"]), _t(c["rho"]), _t(c["mu_b"]),
        _t(c["rho_b"]), eps_k=_t(c["eps"]), eps_b=_t(c["eps_b"]),
        sign_in=tsign[0], sign_out=tsign[1], mode=mode,
        compute_dtype=tdtype, **kw)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("mode", ["two", "fused", "tile"])
@pytest.mark.parametrize("kw", CONV_CASES)
def test_flipout_conv_matches_jax(kw, mode):
    kw, c = _conv_case(np.random.RandomState(2), kw)
    got, want = _both_conv(kw, c, mode)
    np.testing.assert_allclose(to_np(got), want, **TOL)


def test_flipout_conv_bf16_compute_dtype_and_unknown_mode():
    kw, c = _conv_case(np.random.RandomState(3), CONV_CASES[0])
    got, want = _both_conv(kw, c, "two", jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.abs(to_np(got) - want).max() <= _bf16_ulp_of_max(want)
    with pytest.raises(ValueError, match="mode"):
        tconv.flipout_conv(_t(c["x"]), None, _t(c["mu"]), _t(c["rho"]),
                           mode="other")


def _twin(jax_cls, torch_cls, *args, seed=0, **kw):
    jm = jax_cls(*args, rngs=nnx.Rngs(seed), **kw)
    arrays = random_state(jax_arrays(jm), seed=seed)
    import_torch_state_dict(jm, arrays)
    tm = torch_cls(*args, generator=torch.Generator().manual_seed(seed), **kw)
    load_jax_state(tm, arrays)
    return jm, tm


@pytest.mark.parametrize("bias", [True, False])
def test_linear_flipout_layer_and_kl_match_jax(bias):
    jm, tm = _twin(jl.LinearFlipout, tl.LinearFlipout, 7, 5, bias=bias)
    c = _linear_case(np.random.RandomState(4), (2, 3), bias)
    jo, jk = jm(_j(c["x"]), eps_w=_j(c["eps"]), eps_b=_j(c["eps_b"]),
                sign_in=_j(c["sign_in"]), sign_out=_j(c["sign_out"]))
    to, tk = tm(_t(c["x"]), eps_w=_t(c["eps"]), eps_b=_t(c["eps_b"]),
                sign_in=_t(c["sign_in"]), sign_out=_t(c["sign_out"]))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    assert tk.item() == pytest.approx(float(jk), rel=1e-5)
    assert float(tm.kl_loss().detach()) == pytest.approx(float(jm.kl_loss()),
                                                         rel=1e-5)
    assert repr(tm) == repr(jm) == "LinearFlipout()"


@pytest.mark.parametrize("cls,sp", [("Conv1d", (11,)), ("Conv2d", (7, 6)),
                                    ("Conv3d", (4, 5, 3))])
def test_conv_flipout_layers_and_kl_match_jax(cls, sp):
    name = cls + "Flipout"
    jm, tm = _twin(getattr(jl, name), getattr(tl, name), 4, 3, 3, padding=1)
    _, c = _conv_case(np.random.RandomState(5),
                      dict(padding=1, bias=True), cout=3, sp=sp)
    noise = dict(eps_k=c["eps"], eps_b=c["eps_b"], sign_in=c["sign_in"],
                 sign_out=c["sign_out"])
    jo, jk = jm(_j(c["x"]), **{k: _j(v) for k, v in noise.items()})
    to, tk = tm(_t(c["x"]), **{k: _t(v) for k, v in noise.items()})
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    assert tk.item() == pytest.approx(float(jk), rel=1e-5)
    assert repr(tm) == repr(jm)
    tm.dnn_to_bnn_flag = True
    assert isinstance(tm(_t(c["x"])), torch.Tensor)


def test_conv_flipout_gradients_match_jax():
    """d(sum(out * g))/d(mu, rho, mu_b, rho_b, x) with injected noise."""
    kw, c = _conv_case(np.random.RandomState(6), CONV_CASES[1])
    g = np.random.RandomState(7).randn(*c["sign_out"].shape).astype(
        np.float32)
    names = ("x", "mu", "rho", "mu_b", "rho_b")

    def jloss(*p):
        out = jconv.flipout_conv(
            p[0], KEY, *p[1:], eps_k=_j(c["eps"]), eps_b=_j(c["eps_b"]),
            sign_in=_j(c["sign_in"]), sign_out=_j(c["sign_out"]), **kw)
        return (out * g).sum()

    want = jax.grad(jloss, argnums=range(5))(*(_j(c[n]) for n in names))
    params = [_t(c[n]).requires_grad_(True) for n in names]
    out = tconv.flipout_conv(
        params[0], None, *params[1:], eps_k=_t(c["eps"]),
        eps_b=_t(c["eps_b"]), sign_in=_t(c["sign_in"]),
        sign_out=_t(c["sign_out"]), **kw)
    got = torch.autograd.grad((out * _t(g)).sum(), params)
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_uninjected_noise_is_the_counter_hash_under_the_layers_seeds():
    """Without injection the op draws, in this order, one seed for eps,
    one for the bias eps and one for both sign salts; the result equals
    the op fed that noise."""
    kw, c = _conv_case(np.random.RandomState(8), CONV_CASES[0])
    args = [_t(c[n]) for n in ("x", "mu", "rho", "mu_b", "rho_b")]
    got = tconv.flipout_conv(*args[:1], torch.Generator().manual_seed(5),
                             *args[1:], **kw)
    gen = torch.Generator().manual_seed(5)
    seeds = [ts.draw_seed(gen) for _ in range(3)]
    eps = [ts.normal_fused(ts.draw_salt(seed, 0, p.numel()), p.shape)
           for seed, p in zip(seeds, (args[1], args[3]))]
    salts = ts.sign_salts(seeds[2])
    want = tconv.flipout_conv(
        args[0], None, *args[1:], eps_k=eps[0], eps_b=eps[1],
        sign_in=ts.rademacher_fused(salts[0], args[0].shape),
        sign_out=ts.rademacher_fused(salts[1], got.shape), **kw)
    torch.testing.assert_close(got, want, **TOL)
    assert salts[0] != salts[1]
    lin = tlinear.flipout_linear(torch.ones(2, 7),
                                 torch.Generator().manual_seed(5),
                                 torch.zeros(5, 7), torch.zeros(5, 7))
    again = tlinear.flipout_linear(torch.ones(2, 7),
                                   torch.Generator().manual_seed(5),
                                   torch.zeros(5, 7), torch.zeros(5, 7))
    assert torch.equal(lin, again) and bool((lin != 0).any())


def _presampled_pair(rs, delta_scale):
    jc, tc = _twin(jl.Conv2dFlipout, tl.Conv2dFlipout, 3, 4, 3, padding=1)
    jlin, tlin = _twin(jl.LinearFlipout, tl.LinearFlipout, 6, 2)
    for jm, tm, wshape, bshape in ((jc, tc, (4, 3, 3, 3), (4,)),
                                   (jlin, tlin, (2, 6), (2,))):
        w = (delta_scale * rs.randn(*wshape)).astype(np.float32)
        b = (delta_scale * rs.randn(*bshape)).astype(np.float32)
        jm._presampled_w = Presampled(jnp.asarray(w))
        jm._presampled_b = Presampled(jnp.asarray(b))
        tm._presampled_w, tm._presampled_b = _t(w), _t(b)
    return jc, tc, jlin, tlin


def test_presampled_branch_with_zero_delta_is_the_mean_path():
    """``_presampled_w`` is delta = sigma * eps, not a weight: with a zero
    delta both packages return the mean conv / product with mu_bias."""
    rs = np.random.RandomState(9)
    jc, tc, jlin, tlin = _presampled_pair(rs, 0.0)
    x = rs.randn(2, 3, 5, 5).astype(np.float32)
    got = tc(_t(x))[0]
    run = nnx.jit(lambda m, v: m(v)[0])
    np.testing.assert_allclose(to_np(got), np.asarray(run(jc, _j(x))), **TOL)
    torch.testing.assert_close(
        got, tconv.conv_nd(_t(x), tc.mu_kernel, tc.mu_bias, padding=1),
        **TOL)
    h = rs.randn(4, 6).astype(np.float32)
    np.testing.assert_allclose(to_np(tlin(_t(h))[0]),
                               np.asarray(run(jlin, _j(h))), **TOL)


def test_presampled_branch_matches_jax_by_moments():
    """Signs differ between the packages (hash against threefry), so the
    branch is compared over many calls: the mean is the mean path in
    both, and the perturbation's second moment agrees."""
    rs = np.random.RandomState(10)
    jc, tc, _, _ = _presampled_pair(rs, 0.5)
    x = rs.randn(2, 3, 5, 5).astype(np.float32)
    n = 300
    with torch.no_grad():
        mean_path = to_np(tconv.conv_nd(_t(x), tc.mu_kernel, tc.mu_bias,
                                        padding=1))
        got = np.stack([to_np(tc(_t(x))[0]) for _ in range(n)]) - mean_path
    run = nnx.jit(lambda m, v: m(v)[0])  # advances the noise stream
    want = np.stack([np.asarray(run(jc, _j(x))) for _ in range(n)])
    want = want - mean_path
    # per element the perturbation is +-|pert| with pert's own spread
    scale = np.sqrt((want ** 2).mean())
    assert abs(got.mean()) <= 4 * scale / np.sqrt(got.size)
    assert abs(want.mean()) <= 4 * scale / np.sqrt(want.size)
    assert np.sqrt((got ** 2).mean()) == pytest.approx(scale, rel=0.05)
    # two calls flip other signs
    assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("shared", [False, True])
def test_flipout_conv_draws_is_the_single_draw_op_lane_by_lane(shared):
    rs = np.random.RandomState(11)
    S, B, C, O = 3, 2, 4, 5
    x = _t(rs.randn(B, C if shared else S * C, 6, 6))
    mu, mu_b = _t(rs.randn(O, C, 3, 3)), _t(rs.randn(O))
    delta, pert_b = _t(rs.randn(S, O, C, 3, 3)), _t(rs.randn(S, O))
    salts = [ts.sign_salts(99, s) for s in range(S)]
    got = tconv.flipout_conv_draws(x, mu, mu_b, delta, pert_b, salts,
                                   padding=1)
    assert got.shape == (B, S * O, 6, 6)
    for s in range(S):
        xs = x if shared else x[:, s * C:(s + 1) * C]
        want = tconv.flipout_conv_presampled(xs, mu, mu_b, delta[s],
                                             pert_b[s], salts[s], padding=1)
        torch.testing.assert_close(got[:, s * O:(s + 1) * O], want, **TOL)
    with pytest.raises(ValueError, match="channels"):
        tconv.flipout_conv_draws(x[:, :3], mu, mu_b, delta, pert_b, salts)


def test_flipout_conv_draws_matches_jax_structured():
    """The JAX ``flipout_conv_structured`` (channels-last, draw s in
    channel block s) fed the port's hash signs in its own layout."""
    rs = np.random.RandomState(12)
    S, B, C, O, H = 3, 2, 4, 5, 6
    x = rs.randn(B, S * C, H, H).astype(np.float32)
    mu = rs.normal(0, 0.3, (O, C, 3, 3)).astype(np.float32)
    rho = rs.normal(-2, 0.5, (O, C, 3, 3)).astype(np.float32)
    mu_b = rs.normal(0, 0.3, O).astype(np.float32)
    rho_b = rs.normal(-2, 0.5, O).astype(np.float32)
    eps = rs.randn(S, O, C, 3, 3).astype(np.float32)
    eps_b = rs.randn(S, O).astype(np.float32)
    salts = [ts.sign_salts(7, s) for s in range(S)]
    got = tconv.flipout_conv_draws(
        _t(x), _t(mu), _t(mu_b), ts.sigma_from_rho(_t(rho)) * _t(eps),
        ts.sigma_from_rho(_t(rho_b)) * _t(eps_b), salts, padding=1)

    def last(sign):  # (B, S, C, H, W) -> (B, H, W, S*C)
        return jnp.asarray(sign.permute(0, 3, 4, 1, 2).reshape(
            B, H, H, -1).numpy())

    sign_in = ts.rademacher_lanes([a for a, _ in salts], (B, C, H, H))
    sign_out = ts.rademacher_lanes([b for _, b in salts], (B, O, H, H))
    want = jconv.flipout_conv_structured(
        _j(x.transpose(0, 2, 3, 1)), KEY, S, _j(mu), _j(rho), _j(mu_b),
        _j(rho_b), padding=1, eps_k=_j(eps), eps_b=_j(eps_b),
        sign_in=last(sign_in), sign_out=last(sign_out))
    np.testing.assert_allclose(to_np(got),
                               np.asarray(want).transpose(0, 3, 1, 2), **TOL)


@pytest.mark.parametrize("lead", [(4,), (2, 3)])
@pytest.mark.parametrize("shared", [False, True])
def test_flipout_linear_draws_lane_by_lane_and_against_jax(lead, shared):
    rs = np.random.RandomState(13)
    S, K, N = 3, 6, 5
    x = rs.randn(*lead, K if shared else S * K).astype(np.float32)
    mu = rs.normal(0, 0.3, (N, K)).astype(np.float32)
    rho = rs.normal(-2, 0.5, (N, K)).astype(np.float32)
    mu_b = rs.normal(0, 0.3, N).astype(np.float32)
    rho_b = rs.normal(-2, 0.5, N).astype(np.float32)
    eps = rs.randn(S, N, K).astype(np.float32)
    eps_b = rs.randn(S, N).astype(np.float32)
    delta = ts.sigma_from_rho(_t(rho)) * _t(eps)
    pert_b = ts.sigma_from_rho(_t(rho_b)) * _t(eps_b)
    salts = [ts.sign_salts(3, s) for s in range(S)]
    got = tlinear.flipout_linear_draws(_t(x), _t(mu), _t(mu_b), delta,
                                       pert_b, salts)
    assert got.shape == lead + (S * N,)
    for s in range(S):
        xs = _t(x) if shared else _t(x)[..., s * K:(s + 1) * K]
        want = tlinear.flipout_linear_presampled(
            xs, _t(mu), _t(mu_b), delta[s], pert_b[s], salts[s])
        torch.testing.assert_close(got[..., s * N:(s + 1) * N], want, **TOL)
    n = len(lead)
    sign_in = ts.rademacher_lanes([a for a, _ in salts], lead + (K,), axis=n)
    sign_out = ts.rademacher_lanes([b for _, b in salts], lead + (N,),
                                   axis=n)
    want = jlinear.flipout_linear_structured(
        _j(x), KEY, S, _j(mu), _j(rho), _j(mu_b), _j(rho_b), eps_w=_j(eps),
        eps_b=_j(eps_b), sign_in=_j(sign_in.numpy()),
        sign_out=_j(sign_out.numpy()))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


# --- the narrow Flipout ResNet ------------------------------------------------


def test_narrow_flipout_resnet_matches_jax_at_vanishing_sigma():
    jm, tm, _ = tiny_twins(seed=3, rho=-30.0, estimator=FLIPOUT)
    x = np.random.RandomState(14).randn(2, 3, 16, 16).astype(np.float32)
    want, want_kl = nnx.jit(lambda m, v: m(v))(jm, _j(x))
    with torch.no_grad():
        got, kl = tm(_t(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert float(kl) == pytest.approx(float(want_kl), rel=1e-5)
    assert {type(m).__name__ for m in iter_bayesian_layers(tm)} == {
        "Conv2dFlipout", "LinearFlipout"}


def test_flipout_factories_and_the_weight_carry():
    """``resnet_flipout_large`` builds Flipout layers under the JAX
    parameter names, so a JAX Flipout model's arrays load strictly."""
    from bayesian_torch_tpu.models.bayesian import (
        resnet_flipout_large as jzoo)
    from bayesian_torch_tpu_torch.models import _large_resnet
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_flipout_large as tzoo)
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_variational_large as rzoo)

    assert tzoo.__all__ == jzoo.__all__
    tm = tzoo.resnet18(num_classes=10,
                       generator=torch.Generator().manual_seed(0))
    # the same names and shapes as the reparameterization ResNet, which
    # tests/test_torch_port_model.py holds against the JAX model's
    reparam = rzoo.resnet18(num_classes=10).state_dict()
    assert {k: v.shape for k, v in tm.state_dict().items()} == {
        k: v.shape for k, v in reparam.items()}
    # and a JAX Flipout model's arrays load strictly (the narrow ResNet)
    jm, narrow, arrays = tiny_twins(seed=2, estimator=FLIPOUT)
    assert set(arrays) == set(narrow.state_dict()) == set(jax_arrays(jm))
    np.testing.assert_array_equal(
        narrow.layer1[0].downsample[0].mu_kernel.detach().numpy(),
        arrays["layer1.0.downsample.0.mu_kernel"])
    assert isinstance(tm.conv1, tl.Conv2dFlipout)
    assert isinstance(tm.fc, tl.LinearFlipout)
    with pytest.raises(NotImplementedError, match="estimator"):
        _large_resnet.LargeResNet(_large_resnet.BasicBlock, [1, 1, 1, 1],
                                  estimator="Other")
    for layer in (tm.conv1, tm.fc):  # Flipout calibration observers
        layer.prepare()
        assert layer.quant_prepare and len(layer.qint_quant) == 4 \
            and len(layer.quint_quant) == 8
    assert tl.Conv2dFlipout is tl.flipout_layers.Conv2dFlipout
    assert tl.flipout_layers.BaseVariationalLayer_ is tl.BaseVariationalLayer


def _rewound(tm, fn):
    gen = tm.conv1.generator
    state = gen.get_state()
    try:
        return fn()
    finally:
        gen.set_state(state)


def test_mc_forward_loop_and_vmap_agree_lane_for_lane():
    """Under presample="on" both emissions take the same perturbations
    and the same per-draw sign salts, so lane s of the vmap emission is
    the loop's draw s."""
    _, tm, _ = tiny_twins(seed=4, estimator=FLIPOUT)
    x = _t(np.random.RandomState(15).randn(2, 3, 16, 16))
    loop = _rewound(tm, lambda: tmc.mc_forward(tm, x, 3, presample="on",
                                               return_kl=False))
    vmap, kl = _rewound(tm, lambda: tmc.mc_forward(
        tm, x, 3, presample="on", emission="vmap"))
    assert loop.shape == vmap.shape == (3, 2, 10)
    torch.testing.assert_close(vmap, loop, rtol=1e-4, atol=1e-4)
    assert not torch.allclose(loop[0], loop[1])  # the draws differ
    assert float(kl) == pytest.approx(
        float(sum(m.kl_loss().detach() for m in iter_bayesian_layers(tm))),
        rel=1e-5)
    # presample "off": each layer draws its S perturbations in one launch
    off = tmc.mc_forward(tm, x, 3, presample="off", emission="vmap",
                         reduce="mean", return_kl=False)
    assert off.shape == (2, 10) and bool(torch.isfinite(off).all())
    for mod in tm.modules():
        assert not any(hasattr(mod, a) for a in (
            "_presampled_w", "_presampled_b", "_presampled_signs",
            "_mc_draws"))


def test_presample_draws_delta_from_a_zero_mean_in_one_launch(monkeypatch):
    _, tm, _ = tiny_twins(seed=5, estimator=FLIPOUT)
    calls = []
    real = tmc.sample_scaled_normals_batch

    def spy(seed, mu, sigma, *a):
        calls.append(float(mu.abs().max()))
        return real(seed, mu, sigma, *a)

    monkeypatch.setattr(tmc, "sample_scaled_normals_batch", spy)
    S = 4
    touched = dict(tmc._presample_layers(tm, S))
    assert calls == [0.0]  # one launch for the whole model, mu = 0
    assert set(touched) == set(iter_bayesian_layers(tm))
    sigma = ts.sigma_from_rho(tm.conv1.rho_kernel)
    delta = touched[tm.conv1]["_presampled_w"]
    assert delta.shape == (S,) + tuple(tm.conv1.mu_kernel.shape)
    # sigma * eps: no mean, the spread of sigma
    assert float((delta / sigma).mean().abs()) < 0.1
    assert float((delta / sigma).std()) == pytest.approx(1.0, abs=0.1)
    fc = touched[tm.fc]
    assert fc["_presampled_b"].shape == (S, 10)
    assert float(fc["_presampled_b"].abs().max()) < float(
        tm.fc.mu_bias.abs().max())  # sigma_b * eps_b only, no mu_bias
    signs = fc["_presampled_signs"]
    assert signs.shape == (S, 2) and signs.dtype == torch.int64
    assert signs.device.type == "cpu" and len(set(signs.flatten().tolist())) \
        == 2 * S
    # eval resolves presample "auto" to "on" for Flipout as for reparam
    calls.clear()
    tmc.mc_forward(tm, torch.zeros(1, 3, 16, 16), 2, return_kl=False)
    assert calls == [0.0]


def _jax_step(jm, x, y, num_mc, batch, lr):
    def loss_fn(model):
        outs, kl = jmc.mc_forward(model, x, num_mc, emission="vmap")
        log_probs = jax.nn.log_softmax(outs, axis=-1)
        nll = -jnp.take_along_axis(log_probs.mean(axis=0), y[:, None],
                                   axis=1).mean()
        return nll + kl / batch, (nll, kl)

    # one compiled program: op-by-op dispatch of the vmapped gradient
    # costs several times the compile
    (loss, _), grads = nnx.jit(
        nnx.value_and_grad(loss_fn, has_aux=True))(jm)
    nnx.Optimizer(jm, optax.sgd(lr, 0.9), wrt=nnx.Param).update(jm, grads)
    return float(loss), {_torch_key_for(path): np.asarray(v[...])
                         for path, v in nnx.to_flat_state(grads)}


@pytest.mark.parametrize("emission", ["auto", "vmap", "scan"])
def test_flipout_elbo_step_matches_jax(emission):
    """One MC-2 ELBO step at rho = -30: the perturbation vanishes (sigma ~
    1e-13), so the two packages' noise streams do not matter; loss,
    gradients (the KL's rho gradients included), running statistics and
    the parameters after SGD agree at 1e-4."""
    S, B, lr = 2, 4, 0.05
    jm, tm, _ = tiny_twins(seed=6, rho=-30.0, estimator=FLIPOUT)
    set_jax_eval(jm, training=True)
    tm.train()
    rs = np.random.RandomState(16)
    x = rs.randn(B, 3, 16, 16).astype(np.float32)
    y = rs.randint(0, 10, B).astype(np.int32)
    want_loss, want_grads = _jax_step(jm, _j(x), _j(y), S, B, lr)
    opt = torch.optim.SGD(tm.parameters(), lr=lr, momentum=0.9)
    loss, nll, kl = engine.make_train_step(S, B, emission=emission)(
        tm, opt, torch.from_numpy(x), torch.from_numpy(y))
    assert float(loss) == pytest.approx(want_loss, rel=1e-4, abs=1e-4)
    grads = {name: p.grad for name, p in tm.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(to_np(g), want_grads[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    after_j, after_t = jax_arrays(jm), tm.state_dict()
    for name, v in after_t.items():
        np.testing.assert_allclose(to_np(v), after_j[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert int(tm.bn1.num_batches_tracked) == 1


def test_flipout_training_draws_reach_every_rho(monkeypatch):
    """At the default rho the perturbation path carries gradient into
    every rho, through the sampler's backward, under both emissions; the
    vmap emission draws each layer's S perturbations in one launch."""
    _, tm, _ = tiny_twins(seed=7, estimator=FLIPOUT)
    tm.train()
    n_layers = len(list(iter_bayesian_layers(tm)))
    launches = []
    real = ka.sample_gaussian_batch
    monkeypatch.setattr(
        ka, "sample_gaussian_batch",
        lambda seed, mu, *a: launches.append(float(mu.abs().max()))
        or real(seed, mu, *a))
    rs = np.random.RandomState(17)
    x = torch.from_numpy(rs.randn(4, 3, 16, 16).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4))
    for emission in ("scan", "vmap", "auto"):  # "auto" trains through vmap
        opt = torch.optim.SGD(tm.parameters(), lr=0.01)
        launches.clear()
        loss, _, _ = engine.make_train_step(2, 4, emission=emission)(
            tm, opt, x, y)
        assert np.isfinite(float(loss))
        assert launches == ([] if emission == "scan" else [0.0] * n_layers)
        for name, p in tm.named_parameters():
            assert p.grad is not None and bool(
                torch.isfinite(p.grad).all()), name
            if "rho_" in name or "mu_" in name:
                kl_only = torch.autograd.grad(
                    sum(m.kl_loss() for m in iter_bayesian_layers(tm)) / 4,
                    p)[0]
                assert not torch.allclose(p.grad, kl_only), name


def test_pointwise_emission_under_the_flipout_draw_axis(monkeypatch):
    """With ``CONV_1X1_DOT`` a Flipout 1x1 conv under the draw axis is one
    shared pointwise product (mean) and one per-draw product
    (perturbation), and gives what the default route gives."""
    from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

    _, tm, _ = tiny_twins(seed=8, estimator=FLIPOUT)
    x = _t(np.random.RandomState(18).randn(2, 3, 16, 16))
    want = _rewound(tm, lambda: tmc.mc_forward(
        tm, x, 3, presample="on", emission="vmap", return_kl=False))
    calls = {"pointwise_gemm": 0, "mc_gemm": 0}
    for name in calls:
        real = getattr(kg, name)
        monkeypatch.setattr(
            kg, name, lambda *a, _n=name, _r=real: calls.__setitem__(
                _n, calls[_n] + 1) or _r(*a))
    monkeypatch.setattr(tconv, "CONV_1X1_DOT", True)
    got = _rewound(tm, lambda: tmc.mc_forward(
        tm, x, 3, presample="on", emission="vmap", return_kl=False))
    # conv1 and conv3 of both Bottlenecks; the stride-2 downsample is not
    # pointwise
    assert calls == {"pointwise_gemm": 4, "mc_gemm": 4}
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _small_imagenet(data_dir=None, synthetic=False, num_classes=1000):
    return tdata._synthetic(80, (3, 32, 32), num_classes, 4, proto_seed=300)


def test_flipout_trainer_one_tiny_epoch(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer, "load_imagenet_val", _small_imagenet)
    metrics = flipout_trainer.main([
        "--arch=resnet18", "--num-classes=10", "--batch-size=16",
        "--synthetic", "--device=cpu", "--num_monte_carlo=2",
        f"--save_dir={tmp_path}", "--epochs=1"])
    assert 0.0 <= metrics["accuracy"] <= 1.0
    state = torch.load(os.path.join(tmp_path, "imagenet_flipout_resnet18.pt"),
                       weights_only=True)
    assert "layer1.0.conv1.rho_kernel" in state
    assert int(state["bn1.num_batches_tracked"]) == 4
    with open(os.path.join(tmp_path, "imagenet_flipout_metrics.json")) as f:
        assert json.load(f)["accuracy"] == metrics["accuracy"]
    tested = flipout_trainer.main([
        "--arch=resnet18", "--num-classes=10", "--batch-size=16",
        "--synthetic", "--device=cpu", "--num_monte_carlo=2",
        f"--save_dir={tmp_path}", "--mode=test"])
    assert set(tested) == set(metrics)
