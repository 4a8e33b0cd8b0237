"""The port's transposed convolutions and its 1-d and 3-d BatchNorms
against the JAX package, on the CPU.

- ``ops.conv.conv_transpose_nd`` on ``CONVT_CASES`` (the geometry cases of
  ``tests/test_conv_ops.py``: stride, padding, output_padding, dilation,
  groups) against the JAX op, within 1e-4;
- the six ``ConvTranspose*`` layers with injected eps (and Flipout signs):
  output and KL within 1e-5 relative; the gradients of mu and rho (and x)
  against ``jax.grad`` within 1e-4; the fused Flipout mode;
- the draw axis: ``conv_draws`` and ``flipout_conv_draws`` of a
  transposed kernel lane by lane against the single-draw ops and the JAX
  op on each lane's draw, and a Conv -> ConvTranspose model under
  ``mc_forward``'s vmap emission against its draw loop and against the
  JAX vmap emission on the same injected draws;
- ``dnn_to_bnn`` of a model with ``torch.nn.ConvTranspose2d`` (with
  ``output_padding``), with MOPED, against the JAX surgery on the same
  deterministic weights; ``utils.MOPED`` pairing ConvTranspose layers,
  and refusing a Conv / ConvTranspose mismatch by shape;
- ``BatchNorm1dLayer`` / ``BatchNorm3dLayer`` against JAX in training
  (output, running statistics) and eval mode, and the draw-axis forward
  of BN1d / BN3d block by block.

Inputs are numpy arrays from fixed seeds, handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch import nn

import bayesian_torch_tpu.layers as jl
import bayesian_torch_tpu.nn as jdnn
from bayesian_torch_tpu.models import dnn_to_bnn as jax_dnn_to_bnn
from bayesian_torch_tpu.models import get_kl_loss as jax_get_kl_loss
from bayesian_torch_tpu.ops import conv as jconv
from bayesian_torch_tpu.parallel import mc as jmc
from bayesian_torch_tpu.utils import util as jutil
from bayesian_torch_tpu.utils.checkpoint import import_torch_state_dict
import bayesian_torch_tpu_torch.layers as tl
import bayesian_torch_tpu_torch.nn as tnn
from bayesian_torch_tpu_torch.models import dnn_to_bnn, get_kl_loss
from bayesian_torch_tpu_torch.ops import conv as tconv
from bayesian_torch_tpu_torch.ops import sampling as ts
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.utils import MOPED
from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
from tests._torch_port import (FLIPOUT, REPARAM, draw_noise, inject_draws,
                               jax_arrays, random_state, set_jax_eval, to_np)
from tests.test_conv_ops import CONVT_CASES

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
EXACT = dict(rtol=1e-6, atol=1e-7)
KEY = jax.random.key(0)  # unused by the JAX ops once all noise is injected
PRIORS = {"prior_mu": 0.0, "prior_sigma": 1.0, "posterior_mu_init": 0.0,
          "posterior_rho_init": -3.0, "type": REPARAM,
          "moped_enable": True, "moped_delta": 0.2}

# (nd, input spatial, layer geometry) of the layer-level cases
LAYER_CASES = [
    (1, (7,), dict(stride=2, padding=1, output_padding=1)),
    (2, (5, 6), dict(stride=2, padding=1, output_padding=1, groups=2)),
    (3, (3, 4, 3), dict(stride=(1, 2, 2), padding=1, dilation=1)),
]


def _t(a):
    return None if a is None else torch.from_numpy(
        np.asarray(a, dtype=np.float32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _signs(rs, shape):
    return rs.choice([-1.0, 1.0], size=shape).astype(np.float32)


# --- the op ------------------------------------------------------------------


@pytest.mark.parametrize("nd,ci,co,k,s,p,op,d,g", CONVT_CASES)
def test_conv_transpose_nd_matches_jax(nd, ci, co, k, s, p, op, d, g):
    kt = (k,) * nd if isinstance(k, int) else k
    rs = np.random.RandomState(3)
    x = rs.randn(2, ci, *(7,) * nd).astype(np.float32)
    w = rs.randn(ci, co // g, *kt).astype(np.float32)
    b = rs.randn(co).astype(np.float32)
    args = dict(stride=s, padding=p, output_padding=op, dilation=d,
                groups=g)
    want = jconv.conv_transpose_nd(_j(x), _j(w), _j(b), **args)
    got = tconv.conv_transpose_nd(_t(x), _t(w), _t(b), **args)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="string padding"):
        tconv.conv_transpose_nd(_t(x), _t(w), padding="same")


# --- the layers ----------------------------------------------------------


def _layer_twin(estimator, nd, geometry, cin=4, cout=6, bias=True, seed=0):
    """(JAX layer, port layer) of ConvTranspose{nd}d<estimator> holding
    the same random posterior."""
    name = f"ConvTranspose{nd}d{estimator}"
    args = (cin, cout, 3)
    kw = dict(geometry, bias=bias)
    jm = getattr(jl, name)(*args, rngs=nnx.Rngs(seed), **kw)
    arrays = random_state(jax_arrays(jm), seed=seed)
    import_torch_state_dict(jm, arrays)
    tm = getattr(tl, name)(*args, generator=torch.Generator().manual_seed(
        seed), **kw)
    load_jax_state(tm, arrays)
    return jm, tm


def _noise(rs, tm, x_shape, out_shape, flipout):
    noise = dict(eps_k=rs.randn(*tm.mu_kernel.shape).astype(np.float32))
    if tm.mu_bias is not None:
        noise["eps_b"] = rs.randn(tm.out_channels).astype(np.float32)
    if flipout:
        noise["sign_in"] = _signs(rs, x_shape)
        noise["sign_out"] = _signs(rs, out_shape)
    return noise


@pytest.mark.parametrize("estimator", [REPARAM, FLIPOUT])
@pytest.mark.parametrize("nd,sp,geometry", LAYER_CASES)
def test_conv_transpose_layers_match_jax(estimator, nd, sp, geometry):
    jm, tm = _layer_twin(estimator, nd, geometry, seed=nd)
    assert tm.mu_kernel.shape == (4, 6 // geometry.get("groups", 1)) + \
        (3,) * nd
    assert repr(tm) == repr(jm) == f"ConvTranspose{nd}d{estimator}()"
    rs = np.random.RandomState(10 + nd)
    x = rs.randn(2, 4, *sp).astype(np.float32)
    out_shape = tuple(tconv.conv_transpose_nd(
        _t(x), tm.mu_kernel.detach(), **geometry).shape)
    noise = _noise(rs, tm, x.shape, out_shape, estimator == FLIPOUT)
    jo, jk = jm(_j(x), **{k: _j(v) for k, v in noise.items()})
    to, tk = tm(_t(x), **{k: _t(v) for k, v in noise.items()})
    assert tuple(to.shape) == tuple(jo.shape) == out_shape
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    assert tk.item() == pytest.approx(float(jk), rel=1e-5)
    tm.dnn_to_bnn_flag = True
    assert isinstance(tm(_t(x)), torch.Tensor)
    tm.prepare()  # the calibration observers of either estimator
    assert tm.quant_prepare and (len(tm.qint_quant), len(
        tm.quint_quant)) == ((4, 8) if estimator == FLIPOUT else (5, 2))


@pytest.mark.parametrize("estimator", [REPARAM, FLIPOUT])
def test_conv_transpose_gradients_match_jax(estimator):
    """d(sum(out * g))/d(x, mu, rho, mu_b, rho_b) with injected noise, the
    ops with transposed=True."""
    rs = np.random.RandomState(20)
    geometry = dict(stride=2, padding=1, output_padding=1, groups=2)
    x = rs.randn(2, 4, 5, 5).astype(np.float32)
    params = dict(mu=rs.normal(0, 0.3, (4, 3, 3, 3)),
                  rho=rs.normal(-2, 0.5, (4, 3, 3, 3)),
                  mu_b=rs.normal(0, 0.3, 6), rho_b=rs.normal(-2, 0.5, 6))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    out_shape = (2, 6, 10, 10)
    noise = dict(eps_k=rs.randn(4, 3, 3, 3).astype(np.float32),
                 eps_b=rs.randn(6).astype(np.float32))
    if estimator == FLIPOUT:
        noise.update(sign_in=_signs(rs, x.shape),
                     sign_out=_signs(rs, out_shape))
    g = rs.randn(*out_shape).astype(np.float32)
    names = ("x", "mu", "rho", "mu_b", "rho_b")
    values = [x] + [params[n] for n in names[1:]]
    jop = jconv.flipout_conv if estimator == FLIPOUT else \
        jconv.sampled_conv
    top = tconv.flipout_conv if estimator == FLIPOUT else \
        tconv.sampled_conv

    def jloss(*p):
        out = jop(p[0], KEY, *p[1:], transposed=True, **geometry,
                  **{k: _j(v) for k, v in noise.items()})
        return (out * g).sum()

    want = jax.grad(jloss, argnums=range(5))(*map(_j, values))
    leaves = [_t(v).requires_grad_(True) for v in values]
    out = top(leaves[0], None, *leaves[1:], transposed=True, **geometry,
              **{k: _t(v) for k, v in noise.items()})
    assert tuple(out.shape) == out_shape
    got = torch.autograd.grad((out * _t(g)).sum(), leaves)
    for name, a, b in zip(names, got, want):
        assert np.abs(np.asarray(b)).max() > 0, name
        np.testing.assert_allclose(to_np(a), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)


def test_fused_flipout_mode_of_a_transposed_conv():
    """One grouped transposed conv for both halves equals the two convs
    (and the JAX fused mode)."""
    rs = np.random.RandomState(21)
    geometry = dict(stride=2, padding=1, output_padding=1, groups=2)
    x = rs.randn(2, 4, 5, 5).astype(np.float32)
    mu, rho = rs.randn(4, 3, 3, 3), rs.normal(-2, 0.5, (4, 3, 3, 3))
    mu_b, rho_b = rs.randn(6), rs.normal(-2, 0.5, 6)
    eps, eps_b = rs.randn(4, 3, 3, 3), rs.randn(6)
    sign_in, sign_out = _signs(rs, x.shape), _signs(rs, (2, 6, 10, 10))
    args = [mu, rho, mu_b, rho_b]
    noise = dict(eps_k=eps, eps_b=eps_b, sign_in=sign_in, sign_out=sign_out)
    two = tconv.flipout_conv(_t(x), None, *map(_t, args), transposed=True,
                             **geometry, mode="two",
                             **{k: _t(v) for k, v in noise.items()})
    fused = tconv.flipout_conv(_t(x), None, *map(_t, args), transposed=True,
                               **geometry, mode="fused",
                               **{k: _t(v) for k, v in noise.items()})
    want = jconv.flipout_conv(_j(x), KEY, *map(_j, args), transposed=True,
                              **geometry, mode="fused",
                              **{k: _j(v) for k, v in noise.items()})
    torch.testing.assert_close(fused, two, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(fused), np.asarray(want), **TOL)


# --- the draw axis -----------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("shared", [False, True])
def test_transposed_draws_lane_by_lane(shared, groups):
    """``conv_draws`` and ``flipout_conv_draws`` of a transposed kernel:
    lane s is the single-draw op on draw s (and the JAX op on it)."""
    rs = np.random.RandomState(30)
    S, B, I, O = 3, 2, 4, 6
    geometry = dict(stride=2, padding=1, output_padding=1, groups=groups)
    x = _t(rs.randn(B, I if shared else S * I, 5, 5))
    w = _t(rs.randn(S, I, O // groups, 3, 3))
    b = _t(rs.randn(S, O))
    mu, mu_b = _t(rs.randn(I, O // groups, 3, 3)), _t(rs.randn(O))
    salts = [ts.sign_salts(77, s) for s in range(S)]
    got = tconv.conv_draws(x, w, b, transposed=True, **geometry)
    flip = tconv.flipout_conv_draws(x, mu, mu_b, w, b, salts,
                                    transposed=True, **geometry)
    assert got.shape == flip.shape == (B, S * O, 10, 10)
    for s in range(S):
        xs = x if shared else x[:, s * I:(s + 1) * I]
        lane = slice(s * O, (s + 1) * O)
        want = tconv.conv_transpose_nd(xs, w[s], b[s], **geometry)
        torch.testing.assert_close(got[:, lane], want, **TOL)
        jwant = jconv.conv_transpose_nd(_j(xs.numpy()), _j(w[s].numpy()),
                                        _j(b[s].numpy()), **geometry)
        np.testing.assert_allclose(to_np(got[:, lane]), np.asarray(jwant),
                                   **TOL)
        want = tconv.flipout_conv_presampled(xs, mu, mu_b, w[s], b[s],
                                             salts[s], transposed=True,
                                             **geometry)
        torch.testing.assert_close(flip[:, lane], want, **TOL)
    with pytest.raises(ValueError, match="channels"):
        tconv.conv_draws(x[:, :3], w, b, transposed=True, **geometry)


class JaxUpNet(nnx.Module):
    """Conv (down) - BN - ReLU - ConvTranspose (up, output_padding) - the
    spatial mean: (B, 3) outputs."""

    def __init__(self, rngs, estimator=REPARAM):
        self.down = getattr(jl, f"Conv2d{estimator}")(
            3, 4, 3, stride=2, padding=1, rngs=rngs)
        self.bn = jdnn.BatchNorm2d(4)
        self.up = getattr(jl, f"ConvTranspose2d{estimator}")(
            4, 3, 3, stride=2, padding=1, output_padding=1, rngs=rngs)

    def __call__(self, x):
        out, kl = self.down(x)
        out = jax.nn.relu(self.bn(out))
        out, kl_up = self.up(out)
        return out.mean(axis=(2, 3)), kl + kl_up


class TorchUpNet(nn.Module):
    def __init__(self, generator=None, estimator=REPARAM):
        super().__init__()
        self.down = getattr(tl, f"Conv2d{estimator}")(
            3, 4, 3, stride=2, padding=1, generator=generator)
        self.bn = tnn.BatchNorm2d(4)
        self.up = getattr(tl, f"ConvTranspose2d{estimator}")(
            4, 3, 3, stride=2, padding=1, output_padding=1,
            generator=generator)

    def forward(self, x):
        out, kl = self.down(x)
        out = torch.relu(self.bn(out))
        out, kl_up = self.up(out)
        return out.mean(dim=(2, 3)), kl + kl_up


def _upnet_twins(seed, estimator=REPARAM):
    jm = JaxUpNet(nnx.Rngs(seed), estimator)
    arrays = random_state(jax_arrays(jm), seed=seed)
    import_torch_state_dict(jm, arrays)
    tm = TorchUpNet(torch.Generator().manual_seed(seed), estimator)
    load_jax_state(tm, arrays)
    return jm, tm


@pytest.mark.parametrize("training", [False, True])
def test_upnet_vmap_emission_matches_the_loop_and_jax(monkeypatch, training):
    """The same injected draws in both packages: the port's vmap emission
    lane for lane against its draw loop and against the JAX vmap
    emission, in eval and in training mode (each draw's BN batch
    statistics)."""
    S = 3
    jm, tm = _upnet_twins(seed=31)
    set_jax_eval(jm, training=training)
    tm.train(training)
    inject_draws(monkeypatch, draw_noise(tm, S, seed=32))
    x = np.random.RandomState(33).randn(2, 3, 8, 8).astype(np.float32)
    with torch.no_grad():
        loop, kl_loop = tmc.mc_forward(tm, _t(x), S, presample="on",
                                       emission="scan", bn_stats="freeze")
        vmap, kl_vmap = tmc.mc_forward(tm, _t(x), S, presample="on",
                                       emission="vmap", bn_stats="freeze")
    want, want_kl = jmc.mc_forward(jm, _j(x), S, presample="on",
                                   emission="vmap", bn_stats="freeze")
    assert vmap.shape == loop.shape == (S, 2, 3)
    torch.testing.assert_close(vmap, loop, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(vmap), np.asarray(want), **TOL)
    assert float(kl_vmap) == float(kl_loop) == pytest.approx(
        float(want_kl), rel=1e-5)
    assert not torch.allclose(loop[0], loop[1])


def test_flipout_upnet_vmap_emission_matches_the_loop():
    """Flipout: presample "on" gives both emissions the same
    perturbations and sign salts, so lane s is the loop's draw s."""
    _, tm = _upnet_twins(seed=34, estimator=FLIPOUT)
    tm.eval()
    x = _t(np.random.RandomState(35).randn(2, 3, 8, 8))
    gen = tm.down.generator
    state = gen.get_state()
    loop = tmc.mc_forward(tm, x, 3, presample="on", return_kl=False)
    gen.set_state(state)
    vmap = tmc.mc_forward(tm, x, 3, presample="on", emission="vmap",
                          return_kl=False)
    torch.testing.assert_close(vmap, loop, rtol=1e-5, atol=1e-5)
    tm.train()
    outs, kl = tmc.mc_forward(tm, x, 3, emission="vmap")
    (outs.sum() + kl).backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name


# --- model surgery -----------------------------------------------------------


class JaxDetUp(nnx.Module):
    def __init__(self, rngs):
        self.conv = jdnn.Conv2d(3, 4, 3, stride=2, padding=1, rngs=rngs)
        self.up = jdnn.ConvTranspose2d(4, 6, 3, stride=2, padding=1,
                                       output_padding=1, groups=2,
                                       rngs=rngs)
        self.fc = jdnn.Linear(6, 5, rngs=rngs)

    def __call__(self, x):
        out = self.up(jax.nn.relu(self.conv(x)))
        return self.fc(out.mean(axis=(2, 3)))


class TorchDetUp(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, stride=2, padding=1)
        self.up = nn.ConvTranspose2d(4, 6, 3, stride=2, padding=1,
                                     output_padding=1, groups=2)
        self.fc = nn.Linear(6, 5)

    def forward(self, x):
        out = self.up(torch.relu(self.conv(x)))
        return self.fc(out.mean(dim=(2, 3)))


def _det_up_twins(seed):
    jm, tm = JaxDetUp(nnx.Rngs(seed)), TorchDetUp()
    arrays = random_state(jax_arrays(jm), seed=seed)
    import_torch_state_dict(jm, arrays)
    load_jax_state(tm, arrays)
    return jm, tm


def test_dnn_to_bnn_conv_transpose_with_moped_matches_jax(monkeypatch):
    jm, tm = _det_up_twins(seed=40)
    x = np.random.RandomState(41).randn(2, 3, 8, 8).astype(np.float32)
    with torch.no_grad():
        det_out = tm(_t(x))
    np.testing.assert_allclose(to_np(det_out), np.asarray(jm(_j(x))), **TOL)
    w = tm.up.weight.detach().clone()
    jax_dnn_to_bnn(jm, PRIORS)
    dnn_to_bnn(tm, PRIORS)
    twin = tm.up
    assert type(twin) is tl.ConvTranspose2dReparameterization
    assert twin.dnn_to_bnn_flag and twin.transposed
    assert twin.output_padding == (1, 1) and twin.groups == 2
    torch.testing.assert_close(twin.mu_kernel.detach(), w, rtol=0, atol=0)
    after, state = jax_arrays(jm), tm.state_dict()
    assert set(state) == set(after)
    for key, v in state.items():
        np.testing.assert_allclose(to_np(v), after[key], **EXACT,
                                   err_msg=key)
    assert get_kl_loss(tm).item() == pytest.approx(
        float(jax_get_kl_loss(jm)), rel=1e-6)
    S = 2
    inject_draws(monkeypatch, draw_noise(tm, S, seed=42))
    tm.eval()
    set_jax_eval(jm)
    got = tmc.mc_forward(tm, _t(x), S, presample="on", return_kl=False)
    want = jmc.mc_forward(jm, _j(x), S, presample="on", emission="vmap",
                          return_kl=False)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    # Flipout twins too
    _, flip = _det_up_twins(seed=43)
    dnn_to_bnn(flip, dict(PRIORS, type=FLIPOUT))
    assert type(flip.up) is tl.ConvTranspose2dFlipout


def test_moped_pairs_conv_transpose_and_refuses_a_mismatch():
    """MOPED's prior means and posteriors of a ConvTranspose layer are
    the JAX MOPED's on the same deterministic weights; a Conv paired with
    a ConvTranspose of other weight shape raises."""

    class JaxBayesUp(nnx.Module):
        def __init__(self, rngs):
            self.conv = jl.Conv2dReparameterization(3, 4, 3, stride=2,
                                                    padding=1, rngs=rngs)
            self.up = jl.ConvTranspose2dReparameterization(
                4, 6, 3, stride=2, padding=1, output_padding=1, groups=2,
                rngs=rngs)
            self.fc = jl.LinearReparameterization(6, 5, rngs=rngs)

    class TorchBayesUp(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = tl.Conv2dReparameterization(3, 4, 3, stride=2,
                                                    padding=1)
            self.up = tl.ConvTranspose2dReparameterization(
                4, 6, 3, stride=2, padding=1, output_padding=1, groups=2)
            self.fc = tl.LinearReparameterization(6, 5)

    jdet, tdet = _det_up_twins(seed=44)
    jb, tb = JaxBayesUp(nnx.Rngs(0)), TorchBayesUp()
    jutil.MOPED(jb, jdet, None, 0.3)
    MOPED(tb, tdet, None, 0.3)
    for name in ("conv", "up", "fc"):
        jlayer, tlayer = getattr(jb, name), getattr(tb, name)
        for attr in ("prior_weight_mu", "prior_bias_mu"):
            np.testing.assert_allclose(to_np(getattr(tlayer, attr)),
                                       np.asarray(getattr(jlayer, attr)[...]),
                                       **EXACT, err_msg=f"{name}.{attr}")
        for key in ("mu_kernel", "rho_kernel", "mu_weight", "rho_weight",
                    "mu_bias", "rho_bias"):
            if getattr(tlayer, key, None) is not None:
                np.testing.assert_allclose(
                    to_np(getattr(tlayer, key)),
                    np.asarray(getattr(jlayer, key)[...]), **EXACT,
                    err_msg=f"{name}.{key}")
    wrong = TorchDetUp()
    wrong.up = nn.Conv2d(4, 6, 3, groups=2)  # weight (6, 2, 3, 3)
    with pytest.raises(ValueError, match="weight"):
        MOPED(TorchBayesUp(), wrong, None, 0.3)


# --- BatchNorm1d / BatchNorm3d -----------------------------------------------


@pytest.mark.parametrize("nd,sp", [(1, (7,)), (3, (3, 4, 2))])
def test_batchnorm_layers_match_jax(nd, sp):
    name = f"BatchNorm{nd}dLayer"
    jm = getattr(jl, name)(5, rngs=nnx.Rngs(0))
    arrays = random_state(jax_arrays(jm), seed=nd)
    import_torch_state_dict(jm, arrays)
    tm = getattr(tl, name)(5, generator=torch.Generator().manual_seed(0))
    load_jax_state(tm, arrays)
    assert repr(tm) == repr(jm) == f"{name}()"
    rs = np.random.RandomState(50 + nd)
    for step in range(2):  # training: batch statistics, one EMA each
        x = (2.0 * rs.randn(4, 5, *sp) + 0.5).astype(np.float32)
        jo, jk = jm((_j(x), 1.0))
        to, tk = tm((_t(x), 1.0))
        assert tk == jk == 0
        np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
        after = jax_arrays(jm)
        for key, v in tm.state_dict().items():
            np.testing.assert_allclose(to_np(v), after[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    assert int(tm.num_batches_tracked) == 2
    set_jax_eval(jm)
    tm.eval()
    x = rs.randn(3, 5, *sp).astype(np.float32)
    np.testing.assert_allclose(to_np(tm(_t(x))), np.asarray(jm(_j(x))),
                               **TOL)
    with pytest.raises(ValueError):
        tm(_t(rs.randn(3, 5, *sp, 2)))


@pytest.mark.parametrize("nd,sp", [(1, (6,)), (1, ()), (3, (2, 3, 2))])
def test_batchnorm_1d_3d_draw_axis_is_per_block(nd, sp):
    """Under the draw axis each channel block is normalised by its own
    batch statistics (training) or by the running statistics (eval), as
    its own forward would; the records hold each draw's statistics."""
    S, C = 3, 4
    bn = getattr(tnn, f"BatchNorm{nd}d")(C)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 1.5)
    x = _t(np.random.RandomState(60).randn(5, S * C, *sp) * 2 + 1)
    for training in (True, False):
        bn.train(training)
        bn._mc_draws = S
        bn._mc_stats = tmc.MCBatchStats() if training else None
        before = bn.running_mean.clone()
        got = bn(x)
        del bn._mc_draws
        torch.testing.assert_close(bn.running_mean, before, rtol=0, atol=0)
        if training:
            assert bn._mc_stats.stacked().shape == (S, 2, C)
            bn._mc_stats = None
            bn.stats_frozen = True
        for s in range(S):
            want = bn(x[:, s * C:(s + 1) * C])
            torch.testing.assert_close(got[:, s * C:(s + 1) * C], want,
                                       rtol=1e-5, atol=1e-5)
        bn.stats_frozen = False
