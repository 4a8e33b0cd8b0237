"""The port's Bayesian LSTM (``layers/rnn_base.py``) against the JAX layers.

Small shapes: in 4 (and in 1, whose (4H, 1) ih weight JAX draws at the
squeezed (4H,)), H 6, B 3, T 7. JAX's weights are carried by
``load_jax_state``; JAX's own noise is read without touching the package:
the base key from a clone of the layer's rngs, ``fold_in(t)`` and ``split``
per step, then each op's own split (``sampled_linear``: weight and bias;
``flipout_linear``: eps, bias eps and the two sign keys, the signs from
JAX's ``rademacher_fused``), and injected into the port. f32 at 1e-5
absolute and 1e-4 relative. Also held: the KL (T x the blocks' KL), the
hidden-state passthrough, the ``dnn_to_bnn_flag`` return, gradients against
``jax.grad`` under the same noise, the draw axis against the loop under the
same per-draw noise, ``mc_forward(emission="vmap")`` against the loop on a
regressor, one sampler call per tensor, the lanes' independence, the
quantized cell, ``dnn_to_bnn`` / ``bnn_to_qbnn`` / ``prepare`` against JAX's
and ``get_kl_loss``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch import nn

import bayesian_torch_tpu.layers as jl
import bayesian_torch_tpu_torch.layers as tl
from bayesian_torch_tpu_torch.examples.main_bayesian_lstm_timeseries import (
    BayesianLSTMRegressor,
)
from bayesian_torch_tpu.utils.checkpoint import (_torch_key_for,
                                                 import_torch_state_dict)
from bayesian_torch_tpu_torch.layers import rnn_base
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.utils.checkpoint import (load_jax_quant_state,
                                                       load_jax_state)
from tests._torch_port import (FLIPOUT, REPARAM, jax_arrays, lstm_jax_noise,
                               random_state)

TOL = dict(atol=1e-5, rtol=1e-4)
H, B, T = 6, 3, 7
ESTIMATORS = (REPARAM, FLIPOUT)


def _np(x):
    return np.array(x.detach().numpy() if torch.is_tensor(x) else x,
                    dtype=np.float32)


def _twins(estimator, n_in=4, per_step=True, seed=0):
    """(jax LSTM, port LSTM, arrays) on the same random weights; rho
    N(-2, 0.5), so that the noise moves the output well past 1e-5."""
    jm = getattr(jl, "LSTM" + estimator)(
        n_in, H, rngs=nnx.Rngs(params=seed, noise=seed + 1),
        resample_per_step=per_step)
    arrays = random_state(jax_arrays(jm), seed=seed)
    for key in arrays:
        if key.rsplit(".", 1)[-1].startswith("rho"):
            arrays[key] = arrays[key] + np.float32(2.0)
    import_torch_state_dict(jm, arrays)
    tm = getattr(tl, "LSTM" + estimator)(
        n_in, H, generator=torch.Generator().manual_seed(seed),
        resample_per_step=per_step)
    load_jax_state(tm, arrays)
    return jm, tm, arrays


def _torch_noise(noise):
    return {k: tuple(torch.from_numpy(_np(v)) for v in pair)
            for k, pair in noise.items()}


def _x(n_in, seed=1, b=B, t=T):
    return np.random.RandomState(seed).randn(b, t, n_in).astype(np.float32)


@pytest.mark.parametrize("n_in", [4, 1])
@pytest.mark.parametrize("per_step", [True, False])
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_lstm_matches_jax(estimator, per_step, n_in):
    jm, tm, _ = _twins(estimator, n_in, per_step)
    X = _x(n_in)
    noise = _torch_noise(lstm_jax_noise(jm, T, B))
    want, (want_h, want_c), want_kl = jm(jnp.asarray(X))
    got, (got_h, got_c), got_kl = tm(torch.from_numpy(X), **noise)
    assert got.shape == (B, T, H) and got_h is got
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got_c), _np(want_c), **TOL)
    kl_blocks = tm.ih.kl_loss().item() + tm.hh.kl_loss().item()
    assert got_kl.item() == pytest.approx(T * kl_blocks, rel=1e-6)
    assert got_kl.item() == pytest.approx(float(want_kl), rel=1e-5)


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_hidden_state_passthrough_and_flag(estimator):
    """A given (h0, c0) starts the recurrence in both packages;
    ``compute_kl`` off gives kl 0.0; ``dnn_to_bnn_flag`` drops the KL from
    the return."""
    jm, tm, _ = _twins(estimator, seed=3)
    rs = np.random.RandomState(4)
    h0, c0 = (rs.randn(B, H).astype(np.float32) * 0.5 for _ in range(2))
    X = _x(4, seed=5)
    noise = _torch_noise(lstm_jax_noise(jm, T, B))
    want, (_, want_c), _ = jm(jnp.asarray(X), hidden_states=(
        jnp.asarray(h0), jnp.asarray(c0)))
    got, (_, got_c), _ = tm(torch.from_numpy(X), hidden_states=(
        torch.from_numpy(h0), torch.from_numpy(c0)), **noise)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got_c), _np(want_c), **TOL)
    zero_start = tm(torch.from_numpy(X), **noise)[0]
    assert (zero_start - got).abs().max() > 1e-3  # the state mattered

    tm.compute_kl = False
    assert tm(torch.from_numpy(X), **noise)[2] == 0.0
    tm.dnn_to_bnn_flag = True
    jm.dnn_to_bnn_flag = True
    bare = tm(torch.from_numpy(X), **noise)
    assert len(bare) == 2 and len(jm(jnp.asarray(X))) == 2
    out, (h_seq, c_seq) = bare
    assert out.shape == h_seq.shape == c_seq.shape == (B, T, H)
    assert repr(tm) == f"LSTM{estimator}()"


@pytest.mark.parametrize("per_step", [True, False])
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_gradients_match_jax(estimator, per_step):
    """d(sum(out * R) + 0.01 kl) by every mu and rho against ``nnx.grad``
    of the JAX layer under the same noise."""
    jm, tm, _ = _twins(estimator, 4, per_step, seed=7)
    X = _x(4, seed=8)
    R = np.random.RandomState(9).randn(B, T, H).astype(np.float32)
    noise = _torch_noise(lstm_jax_noise(jm, T, B))

    def loss_fn(m):
        out, _, kl = m(jnp.asarray(X))
        return (out * R).sum() + 0.01 * kl

    grads = nnx.grad(loss_fn)(jm)
    want = {_torch_key_for(path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(grads)}
    out, _, kl = tm(torch.from_numpy(X), **noise)
    ((out * torch.from_numpy(R)).sum() + 0.01 * kl).backward()
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for key, p in got.items():
        np.testing.assert_allclose(_np(p.grad), want[key], atol=1e-5,
                                   rtol=1e-4, err_msg=key)


def _per_draw_noise(tm, draws, per_step, seed):
    """Random injected noise for ``draws`` draws: per draw s, the hooks of
    one forward; and the same stacked on a leading S axis."""
    rs = np.random.RandomState(seed)
    lead = (T,) if per_step else ()
    blocks = (tm.ih, tm.hh)
    stacked = dict(
        eps_w=tuple(rs.randn(draws, *lead, *b.mu_weight.shape)
                    for b in blocks),
        eps_b=tuple(rs.randn(draws, *lead, 4 * H) for b in blocks))
    if per_step and tm.estimator == "flipout":
        for side, feats in (("sign_in", (tm.in_features, H)),
                            ("sign_out", (4 * H, 4 * H))):
            stacked[side] = tuple(rs.choice([-1.0, 1.0], (draws, T, B, f))
                                  for f in feats)
    stacked = {k: tuple(torch.from_numpy(a.astype(np.float32)) for a in v)
               for k, v in stacked.items()}
    per_draw = [{k: tuple(a[s] for a in v) for k, v in stacked.items()}
                for s in range(draws)]
    return per_draw, stacked


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("per_step", [True, False])
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_draw_axis_matches_the_loop(estimator, per_step, shared):
    """Under the draw axis (S = 3) lane s equals a single forward of draw s
    under the same noise, for an input shared by the draws and for one
    block per draw, with a (B, S*H) initial state."""
    S = 3
    _, tm, _ = _twins(estimator, 4, per_step, seed=11)
    per_draw, stacked = _per_draw_noise(tm, S, per_step, seed=12)
    rs = np.random.RandomState(13)
    xs = [torch.from_numpy(_x(4, seed=14 if shared else 14 + s))
          for s in range(S)]
    h0 = [torch.from_numpy(rs.randn(B, H).astype(np.float32))
          for _ in range(S)]
    c0 = [torch.from_numpy(rs.randn(B, H).astype(np.float32))
          for _ in range(S)]
    loop = [tm(xs[s], hidden_states=(h0[s], c0[s]), **per_draw[s])
            for s in range(S)]
    tm._mc_draws = S
    try:
        got, (_, got_c), kl = tm(
            xs[0] if shared else torch.cat(xs, -1),
            hidden_states=(torch.cat(h0, -1), torch.cat(c0, -1)), **stacked)
    finally:
        del tm._mc_draws
    assert got.shape == (B, T, S * H)
    for s, (out, (_, c), kl_s) in enumerate(loop):
        np.testing.assert_allclose(_np(got[..., s * H:(s + 1) * H]),
                                   _np(out), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(_np(got_c[..., s * H:(s + 1) * H]),
                                   _np(c), atol=1e-6, rtol=1e-5)
        assert kl.item() == pytest.approx(kl_s.item())


@pytest.mark.parametrize("per_step", [True, False])
def test_one_sampler_call_per_tensor(monkeypatch, per_step):
    """A forward draws each of its four tensors (ih W, ih b, hh W, hh b)
    with one sampler call: T lanes (per step) or one draw, and S*T or S
    lanes under the draw axis; Flipout adds one sign call per block and
    side."""
    calls = []
    for name in ("sample_gaussian", "sample_gaussian_batch"):
        real = getattr(ka, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, args[3] if _name.endswith("batch") else 1))
            return _real(*args, **kw)
        monkeypatch.setattr(ka, name, spy)
    signs = []
    real_signs = rnn_base.rademacher_block

    def sign_spy(salt, whole, start, shape, *args, **kw):
        signs.append(tuple(shape))
        return real_signs(salt, whole, start, shape, *args, **kw)
    monkeypatch.setattr(rnn_base, "rademacher_block", sign_spy)

    X = torch.from_numpy(_x(4))
    for estimator in ESTIMATORS:
        _, tm, _ = _twins(estimator, 4, per_step)
        for draws in (None, 5):
            calls.clear()
            signs.clear()
            if draws:
                tm._mc_draws = draws
            tm(X)
            lanes = (draws or 1) * (T if per_step else 1)
            kind = "sample_gaussian" if lanes == 1 \
                else "sample_gaussian_batch"
            assert calls == [(kind, lanes)] * 4
            flip = per_step and estimator == FLIPOUT
            assert len(signs) == (4 if flip else 0)
            if flip:
                assert signs[0] == ((draws or 1), T, B, 4)
            if draws:
                del tm._mc_draws


def test_lanes_are_independent_draws():
    """The T lanes of one per-step draw are iid N(0, 1) noise around mu:
    per-lane mean and std, and the correlation of every two lanes (and of
    two forwards' lanes) within 4 standard errors."""
    lstm = tl.LSTMReparameterization(32, 32, generator=torch.Generator()
                                     .manual_seed(21))
    with torch.no_grad():
        lstm.hh.mu_weight.zero_()
        lstm.hh.rho_weight.fill_(float(np.log(np.expm1(1.0))))  # sigma 1
        draws = [lstm._draw(lstm.hh, 8, torch.float32, None, None, False)[0]
                 for _ in range(2)]
    eps = torch.cat(draws).reshape(16, -1).double()  # 2 forwards x 8 lanes
    n = eps.shape[1]
    assert (eps.mean(1).abs() < 4 / n ** 0.5).all()
    assert ((eps.std(1) - 1).abs() < 4 / (2 * n) ** 0.5).all()
    corr = torch.corrcoef(eps)
    off = corr[~torch.eye(16, dtype=torch.bool)]
    assert off.abs().max() < 4 / n ** 0.5


def _regressor(estimator, seed=31):
    """The time-series trainer's LSTM(1 -> H) + Linear(H -> 2)."""
    return BayesianLSTMRegressor(H, estimator,
                                 generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_mc_forward_vmap_matches_the_loop(monkeypatch, estimator):
    """``mc_forward(emission="vmap")`` on an LSTM regressor gives (S, B, T,
    2) outputs equal to the draw loop's under the same noise: the LSTM's
    draws from one table (draw s in the loop's s-th forward, all S at
    once under the axis), the head's from a presample of the same draws
    (Flipout: and the same sign salts)."""
    S = 4
    model = _regressor(estimator).eval()
    lstm, head = model.lstm, model.head
    per_draw, stacked = _per_draw_noise(lstm, S, True, seed=32)
    rs = np.random.RandomState(33)
    head_w = torch.from_numpy(rs.randn(S, 2, H).astype(np.float32)) * 0.1
    head_b = torch.from_numpy(rs.randn(S, 2).astype(np.float32)) * 0.1
    forward = rnn_base._BaseLSTMLayer.forward
    calls = []

    def table_forward(self, X, hidden_states=None, return_kl=True):
        if getattr(self, "_mc_draws", None):
            return forward(self, X, hidden_states, return_kl, **stacked)
        calls.append(1)
        return forward(self, X, hidden_states, return_kl,
                       **per_draw[len(calls) - 1])

    attrs = {"_presampled_w": head_w, "_presampled_b": head_b}
    if estimator == FLIPOUT:  # the head's sign salts, one pair a draw
        attrs["_presampled_signs"] = torch.arange(
            1, 2 * S + 1, dtype=torch.int64).reshape(S, 2) * 7919

    def presample(model, num_mc):
        return [(head, attrs)]

    monkeypatch.setattr(rnn_base._BaseLSTMLayer, "forward", table_forward)
    monkeypatch.setattr(tmc, "_presample_layers", presample)
    X = torch.from_numpy(_x(1, seed=34))
    loop, kl_loop = tmc.mc_forward(model, X, S, emission="scan",
                                   presample="on")
    assert len(calls) == S
    vmap, kl_vmap = tmc.mc_forward(model, X, S, emission="vmap",
                                   presample="on")
    assert vmap.shape == loop.shape == (S, B, T, 2)
    np.testing.assert_allclose(_np(vmap), _np(loop), atol=1e-6, rtol=1e-5)
    assert float(kl_vmap) == pytest.approx(float(kl_loop))


def test_draw_axis_takes_the_lstm_and_presample_skips_it():
    """The vmap emission takes an LSTM model (no refusal: the trap that
    would reshape a (B, T, H) output into S blocks), ``auto`` trains
    through it, and the eval presample draws the head alone."""
    model = _regressor(REPARAM)
    assert tmc._draw_axis_refusal(model) is None
    assert tmc._resolve_emission(model, 4, training=True) == "vmap"
    touched = tmc._presample_layers(model.eval(), 3)
    assert [layer for layer, _ in touched] == [model.head]
    out, _ = tmc.mc_forward(model, torch.from_numpy(_x(1)), 3,
                            emission="vmap")
    assert out.shape == (3, B, T, 2)


# --- the quantized cell, bnn_to_qbnn and prepare ---------------------------


class _JaxNet(nnx.Module):
    def __init__(self, rnn):
        self.rnn = rnn


class _TorchNet(nn.Module):
    def __init__(self, rnn):
        super().__init__()
        self.rnn = rnn


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_quantized_cell_matches_jax(estimator):
    """``bnn_to_qbnn`` quantizes ih and hh in place in both packages; the
    int8 state carried by ``load_jax_quant_state`` and JAX's eps (the base
    key split in two) and bias eps (the next two keys) injected, the
    quantized cell equals JAX's; its KL is 0.0, and the model runs the
    draw loop."""
    from bayesian_torch_tpu.models.bnn_to_qbnn import bnn_to_qbnn as jq
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn

    jm, tm, _ = _twins(estimator, 4, seed=41)
    jnet, tnet = _JaxNet(jm), _TorchNet(tm)
    jq(jnet)
    bnn_to_qbnn(tnet)
    assert type(tnet.rnn).__name__ == f"LSTM{estimator}"
    for block in (tnet.rnn.ih, tnet.rnn.hh):
        assert type(block).__name__ == f"QuantizedLinear{estimator}"
    load_jax_quant_state(tnet, jax_arrays(jnet))
    rngs = nnx.clone(jnet.rnn.rngs)
    k_i, k_h = jax.random.split(rngs.noise())
    eps_w = (jax.random.normal(k_i, jm.ih.quantized_mu_weight.shape),
             jax.random.normal(k_h, jm.hh.quantized_mu_weight.shape))
    eps_b = (jax.random.normal(rngs.noise(), (4 * H,)),
             jax.random.normal(rngs.noise(), (4 * H,)))
    X = _x(4, seed=42)
    want, (_, want_c), want_kl = jnet.rnn(jnp.asarray(X))
    got, (_, got_c), got_kl = tnet.rnn(
        torch.from_numpy(X), eps_w=tuple(torch.from_numpy(_np(e))
                                         for e in eps_w),
        eps_b=tuple(torch.from_numpy(_np(e)) for e in eps_b))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got_c), _np(want_c), **TOL)
    assert got_kl == 0.0 and want_kl == 0.0
    samples = [tnet.rnn(torch.from_numpy(X))[0] for _ in range(2)]
    assert (samples[0] - samples[1]).abs().max() > 0  # redrawn each call
    bnn_to_qbnn(tnet)  # already quantized blocks stay
    assert type(tnet.rnn.ih).__name__ == f"QuantizedLinear{estimator}"


def test_quantized_lstm_runs_the_draw_loop():
    """A converted regressor takes the draw axis (its quantized blocks and
    head do; test_torch_port_int8_draws.py holds it against the loop), but
    ``auto`` runs the loop, in training mode too: a converted model has
    nothing to train."""
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn

    model = _regressor(REPARAM)
    bnn_to_qbnn(model)
    assert tmc._draw_axis_refusal(model) is None
    assert tmc._resolve_emission(model, 4, training=True) == "scan"
    X = torch.from_numpy(_x(1))
    out, kl = tmc.mc_forward(model.eval(), X, 3)
    assert out.shape == (3, B, T, 2) and float(kl) == 0.0
    assert (out[0] - out[1]).abs().max() > 0
    out, kl = tmc.mc_forward(model, X, 3, emission="vmap")
    assert out.shape == (3, B, T, 2) and float(kl) == 0.0


def test_prepare_and_convert_walk_into_the_lstm():
    """As JAX's ``enable_prepare``: ``prepare`` gives ih and hh observers
    (the LSTM has no ``prepare`` of its own), the LSTM forward reads its
    posteriors directly so nothing is observed, and ``convert`` leaves
    both blocks uncalibrated, as in JAX."""
    from bayesian_torch_tpu.quantization import convert as jconvert
    from bayesian_torch_tpu.quantization import prepare as jprepare
    from bayesian_torch_tpu_torch.quantization import convert, prepare

    jm, tm, _ = _twins(REPARAM, 4, seed=51)
    jnet, tnet = _JaxNet(jm), _TorchNet(tm)
    jprepare(jnet)
    prepare(tnet)
    for jb, tb in ((jm.ih, tm.ih), (jm.hh, tm.hh)):
        assert jb.quant_prepare and tb.quant_prepare
        assert len(tb.qint_quant) == len(jb.qint_quant) == 5
    X = _x(4, seed=52)
    jnet.rnn(jnp.asarray(X))
    tnet.rnn(torch.from_numpy(X))
    assert tmc._draw_axis_refusal(tnet)[0] == "rnn.ih"
    jconvert(jnet)
    convert(tnet)
    for jb, tb in ((jnet.rnn.ih, tnet.rnn.ih), (jnet.rnn.hh, tnet.rnn.hh)):
        assert jb.quant_dict is None and tb.quant_dict is None
        assert type(tb).__name__ == type(jb).__name__
    out, _, kl = tnet.rnn(torch.from_numpy(X))
    assert out.shape == (B, T, H) and torch.isfinite(out).all()


# --- dnn_to_bnn and get_kl_loss -------------------------------------------

PRIORS = {"prior_mu": 0.1, "prior_sigma": 0.5, "posterior_mu_init": 0.0,
          "posterior_rho_init": -4.0, "type": REPARAM,
          "moped_enable": False, "moped_delta": 0.5}


@pytest.mark.parametrize("moped", [False, True])
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_dnn_to_bnn_converts_lstms_as_jax(estimator, moped, capsys):
    """``torch.nn.LSTM`` and ``LSTMCell`` become the Bayesian twin as JAX's
    ``nn.LSTM`` and ``nnx.RNN(OptimizedLSTMCell)`` do: geometry, bias,
    priors, posterior init, the flag, and with MOPED the warning and the
    random initialisation kept."""
    import bayesian_torch_tpu.nn as jnn
    from bayesian_torch_tpu.models.dnn_to_bnn import dnn_to_bnn as jd
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import dnn_to_bnn

    params = dict(PRIORS, type=estimator, moped_enable=moped)

    class JNet(nnx.Module):
        def __init__(self, rngs):
            self.rnn = jnn.LSTM(5, 8, rngs=rngs)
            self.cell = nnx.RNN(nnx.OptimizedLSTMCell(6, 12, rngs=rngs))

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.rnn = nn.LSTM(5, 8, batch_first=True)
            self.cell = nn.LSTMCell(6, 12)

    jnet, tnet = JNet(nnx.Rngs(0)), TNet()
    jd(jnet, params)
    jax_printed = capsys.readouterr().out
    dnn_to_bnn(tnet, params)
    assert capsys.readouterr().out == jax_printed
    assert ("MOPED method is not supported" in jax_printed) == moped
    for name in ("rnn", "cell"):
        jb, tb = getattr(jnet, name), getattr(tnet, name)
        assert type(tb).__name__ == type(jb).__name__ == f"LSTM{estimator}"
        for attr in ("in_features", "out_features", "bias", "prior_mean",
                     "prior_variance", "posterior_mu_init",
                     "posterior_rho_init", "dnn_to_bnn_flag",
                     "resample_per_step"):
            assert getattr(tb, attr) == getattr(jb, attr), (name, attr)
        for block in ("ih", "hh"):
            jl_, tl_ = getattr(jb, block), getattr(tb, block)
            assert tuple(tl_.mu_weight.shape) == tuple(jl_.mu_weight.shape)
            assert float(tl_.prior_weight_sigma) == 0.5
            assert abs(float(tl_.rho_weight.mean()) + 4.0) < 0.05
    out = tnet.rnn(torch.randn(2, 3, 5))
    assert len(out) == 2 and out[0].shape == (2, 3, 8)


@pytest.mark.parametrize("kw, attr", [
    (dict(num_layers=2), "num_layers"),
    (dict(bidirectional=True), "bidirectional"),
    (dict(proj_size=2), "proj_size"),
    (dict(batch_first=False), "batch_first")])
def test_dnn_to_bnn_refuses_what_one_layer_cannot_be(kw, attr):
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import dnn_to_bnn

    with pytest.raises(ValueError, match=attr):
        dnn_to_bnn(nn.Sequential(nn.LSTM(3, 4, **{"batch_first": True,
                                                   **kw})), PRIORS)


def test_get_kl_loss_counts_the_lstm_once():
    from bayesian_torch_tpu.models.dnn_to_bnn import get_kl_loss as jkl
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import get_kl_loss

    jm, tm, _ = _twins(REPARAM, 4, seed=61)
    want = float(jkl(_JaxNet(jm)))
    got = get_kl_loss(_TorchNet(tm))
    assert got.item() == pytest.approx(want, rel=1e-6)
    assert got.item() == pytest.approx(tm.ih.kl_loss().item()
                                       + tm.hh.kl_loss().item(), rel=1e-6)


# --- the LSTM under mc_forward(mesh=): a rank's windows --------------------


def test_windowed_draws_and_signs_equal_the_whole_launch():
    """Under a ``DrawWindow`` a rank's LSTM draws are its lanes of the
    single-process launch element for element: draws [2, 4) of 4 are
    lanes [2T, 4T) of each tensor's S*T-lane K-A launch (weights and
    Flipout perturbations), their K-C dsigma the whole launch's with the
    cotangent on those lanes, and the Flipout signs the block [2, 4) x
    rows [1, 3) of the whole (S, T, B, F) signs; a shard of rows [r0, r0 +
    n) of a (4H, K) posterior takes offset r0*K of the whole lane."""
    from bayesian_torch_tpu_torch.ops.sampling import (DrawWindow,
                                                       draw_window,
                                                       sigma_from_rho,
                                                       step_lanes)

    S, rows = 4, 4
    for estimator in ESTIMATORS:
        _, tm, _ = _twins(estimator, 4, seed=51)
        flip = estimator == FLIPOUT
        for lin in (tm.ih, tm.hh):
            state = tm.generator.get_state()
            whole = tm._draw(lin, S * T, torch.float32, None, None, flip, S)
            tm.generator.set_state(state)
            with draw_window(DrawWindow(2, 2, S, 0, rows, rows)):
                part = tm._draw(lin, 2 * T, torch.float32, None, None, flip,
                                2)
            for w, p in zip(whole, part):
                assert torch.equal(p, w[2 * T:])
            g = torch.randn(part[0].shape, generator=torch.Generator()
                            .manual_seed(52))
            lin.zero_grad()
            (part[0] * g).sum().backward()
            got = lin.rho_weight.grad.clone()
            lin.zero_grad()
            placed = torch.zeros(whole[0].shape)
            placed[2 * T:] = g
            (whole[0] * placed).sum().backward()
            assert torch.equal(got, lin.rho_weight.grad)
        state = tm.generator.get_state()
        signs = tm._signs(S, T, rows, torch.float32, None, None, None)
        tm.generator.set_state(state)
        with draw_window(DrawWindow(2, 2, S, 1, 2, rows)):
            block = tm._signs(2, T, 2, torch.float32, None, None, None)
        for w, p in zip(signs, block):
            assert torch.equal(p, w[2:, :, 1:3])
    # sigma from the whole rho once: torch's CPU softplus of a slice can
    # differ from the whole tensor's in the last ulp (its vector loop and
    # scalar tail), which is no part of K-A's window
    mu = tm.hh.mu_weight.detach()
    sigma = sigma_from_rho(tm.hh.rho_weight.detach())
    K = mu.shape[1]
    whole = ka.sample_scaled_normals_batch(99, mu, sigma, S * T,
                                           torch.float32)
    for r0 in (0, 2 * H):  # the two row shards of (4H, K)
        n = 2 * H * K
        with draw_window(DrawWindow(2, 2, S, 0, rows, rows)):
            kw = step_lanes(2, T, n, whole=mu.numel(), offset=r0 * K)
        assert kw == {"window": (2 * T, mu.numel(), r0 * K)}
        got = ka.sample_scaled_normals_batch(99, mu[r0:r0 + 2 * H],
                                             sigma[r0:r0 + 2 * H], 2 * T,
                                             torch.float32, **kw)
        assert torch.equal(got, whole[2 * T:, r0:r0 + 2 * H])
    assert step_lanes(S, T, 10) == {}  # no window: the whole launch


@pytest.mark.parametrize("per_step", [True, False])
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_bf16_lstm_matches_jax(estimator, per_step):
    """``compute_dtype=bfloat16`` against JAX's ``jnp.bfloat16`` under
    JAX's own noise (drawn in bf16 as its ops draw it): per-step draws
    within 4 bf16 ulps of max|out| at every step (the weights are rounded
    once here, per op in JAX: 1.3 ulps measured); the state is carried in
    the input's dtype (f32) in both. One draw per sequence samples and
    multiplies in f32 in both, whatever the compute dtype: within the f32
    tolerance."""
    jm = getattr(jl, "LSTM" + estimator)(
        4, H, rngs=nnx.Rngs(params=0, noise=1), resample_per_step=per_step,
        compute_dtype=jnp.bfloat16)
    arrays = random_state(jax_arrays(jm), seed=0)
    for key in arrays:
        if key.rsplit(".", 1)[-1].startswith("rho"):
            arrays[key] = arrays[key] + np.float32(2.0)
    import_torch_state_dict(jm, arrays)
    tm = getattr(tl, "LSTM" + estimator)(
        4, H, generator=torch.Generator().manual_seed(0),
        resample_per_step=per_step, compute_dtype=torch.bfloat16)
    load_jax_state(tm, arrays)
    X = _x(4, seed=61)
    noise = {k: tuple(torch.tensor(np.asarray(v, dtype=np.float32))
                      for v in pair)
             for k, pair in lstm_jax_noise(jm, T, B).items()}
    want, (_, want_c), _ = jm(jnp.asarray(X))
    got, (_, got_c), _ = tm(torch.from_numpy(X), **noise)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    want, want_c = _np(np.asarray(want)), _np(np.asarray(want_c))
    if not per_step:
        np.testing.assert_allclose(_np(got), want, **TOL)
        np.testing.assert_allclose(_np(got_c), want_c, **TOL)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    steps = np.abs(_np(got) - want).max(axis=(0, 2)) / ulp
    assert steps.max() <= 4, steps
    assert np.abs(_np(got) - want).max() > 0  # bf16, not f32 arithmetic
