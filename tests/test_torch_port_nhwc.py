"""Channels-last (``data_format="NHWC"``) in the port's ops and layers
against the JAX package's NHWC results, on the CPU (the models:
``test_torch_port_nhwc_model.py``).

Inputs and weights come from numpy seeds and are handed to both packages
(weights through ``load_jax_state``); noise is injected (eps, signs) or
drawn from the counter hash on the same salt. Tolerances: f32 1e-4 x
max|out| or tighter (order of summation, other conv algorithms), int8 and
the Flipout signs bit for bit.

- ``conv_nd`` / ``conv_transpose_nd`` in 1, 2 and 3 dimensions; the NHWC
  output is the NCHW output permuted, and contiguous in (B, *sp, C) (no
  NCHW copy was made);
- the pointwise emission under NHWC through K-G channels-last's wrappers
  (their plain versions here), against JAX's einsum emission and its
  gradient; K-G channels-last's plain version against the function of
  ``_gemm_kernel`` (``jnp.einsum("msc,sco->mso")``) and against the Pallas
  kernels it replaces in interpret mode;
- every conv layer in both estimators with injected eps and signs; the
  Flipout op with its signs from the counter hash on JAX's salts (JAX's
  NHWC flat order); the draw-axis ops against JAX's structured ops;
- BatchNorm in training and eval, and under the draw axis (per-block
  statistics, one EMA update); the pools;
- ``qconv`` (bit for bit).

The mesh paths under NHWC: ``test_torch_port_nhwc_mesh.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

import bayesian_torch_tpu.layers as jl
import bayesian_torch_tpu.nn as jdnn
import bayesian_torch_tpu_torch.layers as tl
import bayesian_torch_tpu_torch.nn as tdnn
from bayesian_torch_tpu.nn import functional as jF
from bayesian_torch_tpu.ops import conv as jconv
from bayesian_torch_tpu.ops import int8 as jq
from bayesian_torch_tpu.ops import sampling as js
from bayesian_torch_tpu.utils.checkpoint import import_torch_state_dict
from bayesian_torch_tpu_torch.nn import functional as tF
from bayesian_torch_tpu_torch.ops import conv as tconv
from bayesian_torch_tpu_torch.ops import int8 as tq
from bayesian_torch_tpu_torch.ops import sampling as ts
from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
from tests._torch_port import (FLIPOUT, REPARAM, jax_arrays, random_state,
                               to_np)

KEY = jax.random.key(0)  # unused by the JAX ops once all noise is injected


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32)).to(dtype)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, rel=1e-4):
    """|got - want| <= rel x max|want| everywhere."""
    got, want = to_np(got), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _last(a):
    """(B, C, *sp) -> (B, *sp, C)."""
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


# --- conv_nd / conv_transpose_nd -------------------------------------------

CONV_CASES = [
    (1, dict(stride=2, padding=1), 1),
    (2, dict(stride=1, padding=1, dilation=2), 1),
    (2, dict(stride=2, padding=0, groups=2), 2),
    (3, dict(stride=1, padding=1), 1),
]


@pytest.mark.parametrize("nd,kw,groups", CONV_CASES)
@pytest.mark.parametrize("transposed", [False, True])
def test_conv_ops_match_jax_nhwc(nd, kw, groups, transposed):
    rs = np.random.RandomState(nd * 10 + groups)
    cin, cout, k = 4, 6, 3
    x = rs.randn(2, cin, *(7,) * nd).astype(np.float32)
    kshape = ((cin, cout // groups) if transposed
              else (cout, cin // groups)) + (k,) * nd
    w = rs.randn(*kshape).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    kw = dict(kw, groups=groups)
    if transposed:
        kw["output_padding"] = 1 if kw["stride"] > 1 else 0
    jop = jconv.conv_transpose_nd if transposed else jconv.conv_nd
    top = tconv.conv_transpose_nd if transposed else tconv.conv_nd
    want = jop(_j(_last(x)), _j(w), _j(b), data_format="NHWC", **kw)
    got = top(_t(_last(x)), _t(w), _t(b), data_format="NHWC", **kw)
    _close(got, want)
    nchw = top(_t(x), _t(w), _t(b), **kw)
    _close(got, to_np(nchw.movedim(1, -1)), rel=1e-5)
    if nd > 1:  # 1-d has no channels-last memory format in torch
        assert got.is_contiguous()


# --- K-G channels-last: plain version and the pointwise emission -----------


@pytest.mark.parametrize("S,shared", [(3, False), (3, True), (1, False)])
def test_kg_cl_plain_is_the_gemm_kernels_function(S, shared):
    """The plain version against ``jnp.einsum("msc,sco->mso")``, the
    function ``_gemm_kernel`` computes (its weight (S, C, O)), and against
    the Pallas kernels in interpret mode: ``pallas_mc_gemm`` on (M, S, C)
    as it lies, and ``pallas_matmul`` at S = 1."""
    from benchmarks.bench_1x1_mc import pallas_mc_gemm
    from benchmarks.bench_mosaic_matmul import pallas_matmul

    rs = np.random.RandomState(S)
    M, C, O = 32, 16, 24
    x = rs.randn(M, C) if shared else rs.randn(M, S, C)
    x = x.astype(np.float32)
    w = rs.randn(S, O, C).astype(np.float32)
    got = kg.mc_gemm_cl_plain(_t(x), _t(w))
    xs = np.broadcast_to(x[:, None], (M, S, C)) if shared else x
    wj = w.transpose(0, 2, 1)
    want = jnp.einsum("msc,sco->mso", _j(xs), _j(wj))
    _close(got, want, rel=1e-5)
    with pltpu.force_tpu_interpret_mode():
        if S == 1:
            pallas = pallas_matmul(_j(xs[:, 0]), _j(wj[0]), 16, 8, 16)[:, None]
        else:
            pallas = pallas_mc_gemm(_j(np.ascontiguousarray(xs)), _j(wj), 16,
                                    8, 16)
    _close(got, pallas, rel=1e-5)
    if not shared and S == 1:
        _close(kg.pointwise_gemm_cl(_t(x[:, 0]), _t(w[0])), want[:, 0],
               rel=1e-5)


def test_kg_cl_wrappers_refuse_what_the_kernel_does_not_take():
    x, w = torch.zeros(4, 2, 8), torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        kg.mc_gemm_cl(x.to(torch.int8), w.to(torch.int8))
    with pytest.raises(ValueError, match="draws or channels"):
        kg.mc_gemm_cl(torch.zeros(4, 3, 8), w)
    with pytest.raises(ValueError, match="pointwise_gemm_cl"):
        kg.mc_gemm_cl(x, w[0])
    with pytest.raises(ValueError, match=r"need bias \(2, 3\)"):
        kg.mc_gemm_cl(x, w, torch.zeros(3))


@pytest.mark.parametrize("draws", [None, "shared", "lanes"])
def test_pointwise_emission_nhwc_matches_jax_and_trains(monkeypatch, draws):
    """With ``CONV_1X1_DOT = True`` a 1x1 NHWC conv goes to K-G
    channels-last (the plain version on the CPU), forward and input
    gradient, and equals JAX's emission (its einsum) and ``jax.grad``
    through it; the draw axis against JAX's structured conv."""
    monkeypatch.setattr(tconv, "CONV_1X1_DOT", True)
    monkeypatch.setattr(jconv, "CONV_1X1_DOT", True)
    calls = []
    real = kg._apply_cl
    monkeypatch.setattr(kg, "_apply_cl",
                        lambda *a: calls.append(a[4]) or real(*a))
    rs = np.random.RandomState(7)
    S, B, H, C, O = 3, 2, 5, 6, 4
    cin = S * C if draws == "lanes" else C
    x = rs.randn(B, H, H, cin).astype(np.float32)
    w = rs.randn(*((S,) if draws else ()), O, C, 1, 1).astype(np.float32)
    b = rs.randn(*((S,) if draws else ()), O).astype(np.float32)
    g = rs.randn(B, H, H, S * O if draws else O).astype(np.float32)

    def jfwd(x, w, b):
        if draws is None:
            return jconv.conv_nd(x, w, b, data_format="NHWC")
        wt = w.reshape((S * O, C, 1, 1))
        return jconv.conv_nd(x, wt, b.reshape(-1), data_format="NHWC",
                             groups=S if draws == "lanes" else 1)

    want, vjp = jax.vjp(jfwd, _j(x), _j(w), _j(b))
    jgrads = vjp(_j(g))
    xt, wt, bt = (_t(a).requires_grad_(True) for a in (x, w, b))
    if draws is None:
        got = tconv.conv_nd(xt, wt, bt, data_format="NHWC")
    else:
        got = tconv.conv_draws(xt, wt, bt, data_format="NHWC")
    _close(got, want, rel=1e-5)
    got.backward(_t(g))
    for t, j in zip((xt, wt, bt), jgrads):
        _close(t.grad, j, rel=1e-5)
    wrapper = kg.pointwise_gemm_cl if draws is None else kg.mc_gemm_cl
    assert calls == [wrapper, wrapper]  # forward and dx


# --- the layers --------------------------------------------------------------


def _layer_case(rs, transposed, nd, bias, S=None):
    cin, cout, k = 4, 6, 3
    kshape = ((cin, cout) if transposed else (cout, cin)) + (k,) * nd
    lead = () if S is None else (S,)
    return dict(
        x=_last(rs.randn(2, cin, *(6,) * nd).astype(np.float32)),
        eps=rs.randn(*lead, *kshape).astype(np.float32),
        eps_b=rs.randn(*lead, cout).astype(np.float32) if bias else None)


def _twin_layers(jcls, tcls, args, kw, rho=None):
    jm = jcls(*args, rngs=nnx.Rngs(0), data_format="NHWC", **kw)
    arrays = random_state(jax_arrays(jm), seed=1, rho=rho)
    import_torch_state_dict(jm, arrays)
    tm = tcls(*args, generator=torch.Generator().manual_seed(0),
              data_format="NHWC", **kw)
    load_jax_state(tm, arrays)
    return jm, tm


LAYERS = [("Conv1d", 1, False), ("Conv2d", 2, False), ("Conv3d", 3, False),
          ("ConvTranspose2d", 2, True)]


@pytest.mark.parametrize("name,nd,transposed", LAYERS)
@pytest.mark.parametrize("estimator", [REPARAM, FLIPOUT])
def test_conv_layers_match_jax_nhwc(name, nd, transposed, estimator):
    rs = np.random.RandomState(nd + 3 * transposed)
    jm, tm = _twin_layers(getattr(jl, name + estimator),
                          getattr(tl, name + estimator), (4, 6, 3),
                          dict(stride=2, padding=1))
    assert tm.data_format == jm.data_format == "NHWC"
    c = _layer_case(rs, transposed, nd, True)
    noise = dict(eps_k=c["eps"], eps_b=c["eps_b"])
    if estimator == FLIPOUT:
        out_shape = tm(_t(c["x"]), eps_k=_t(c["eps"]),
                       eps_b=_t(c["eps_b"]))[0].shape
        noise["sign_in"] = rs.choice([-1.0, 1.0], c["x"].shape)
        noise["sign_out"] = rs.choice([-1.0, 1.0], tuple(out_shape))
    want, jkl = jm(_j(c["x"]), **{k: _j(v.astype(np.float32))
                                  for k, v in noise.items()})
    got, tkl = tm(_t(c["x"]), **{k: _t(v) for k, v in noise.items()})
    _close(got, want)
    assert float(tkl.detach()) == pytest.approx(float(jkl), rel=1e-5)
    if nd == 2:
        assert got.is_contiguous()


@pytest.mark.parametrize("shape", [(2, 5, 5, 4), (2, 3, 7, 4, 4)])
def test_flipout_signs_are_jax_hash_in_nhwc_flat_order(shape):
    """Uninjected signs: the port's counter hash on the salts of JAX's two
    sign keys gives JAX's NHWC signs bit for bit, and the op equals JAX's
    ``flipout_conv`` with eps injected and its signs drawn."""
    rs = np.random.RandomState(len(shape))
    nd = len(shape) - 2
    C, O = shape[-1], 5
    x = rs.randn(*shape).astype(np.float32)
    mu = rs.normal(0, 0.3, (O, C) + (3,) * nd).astype(np.float32)
    rho = rs.normal(-2, 0.5, mu.shape).astype(np.float32)
    mu_b = rs.normal(0, 0.3, O).astype(np.float32)
    rho_b = rs.normal(-2, 0.5, O).astype(np.float32)
    eps, eps_b = rs.randn(*mu.shape), rs.randn(O)
    eps, eps_b = eps.astype(np.float32), eps_b.astype(np.float32)
    key = jax.random.key(11)
    _, _, k_sin, k_sout = jax.random.split(key, 4)
    salts = (int(js._key_salt(k_sin)), int(js._key_salt(k_sout)))
    np.testing.assert_array_equal(
        ts.rademacher_fused(salts[0], shape).numpy(),
        np.asarray(js.rademacher_fused(k_sin, shape)))
    want = jconv.flipout_conv(_j(x), key, _j(mu), _j(rho), _j(mu_b),
                              _j(rho_b), padding=1, eps_k=_j(eps),
                              eps_b=_j(eps_b), data_format="NHWC")
    got = tconv.flipout_conv_presampled(
        _t(x), _t(mu), _t(mu_b), ts.sigma_from_rho(_t(rho)) * _t(eps),
        ts.sigma_from_rho(_t(rho_b)) * _t(eps_b), salts, padding=1,
        data_format="NHWC")
    _close(got, want, rel=1e-5)


@pytest.mark.parametrize("estimator", [REPARAM, FLIPOUT])
@pytest.mark.parametrize("shared", [False, True])
def test_draw_axis_ops_match_jax_structured(estimator, shared):
    """``conv_draws`` / ``flipout_conv_draws`` under NHWC take JAX's
    structured layout (B, *sp, S*C) as it is: against
    ``sampled_conv_structured`` / ``flipout_conv_structured`` fed the same
    eps and the port's per-lane signs in that layout."""
    rs = np.random.RandomState(12 + shared)
    S, B, C, O, H = 3, 2, 4, 5, 6
    x = rs.randn(B, H, H, C if shared else S * C).astype(np.float32)
    mu = rs.normal(0, 0.3, (O, C, 3, 3)).astype(np.float32)
    rho = rs.normal(-2, 0.5, (O, C, 3, 3)).astype(np.float32)
    mu_b = rs.normal(0, 0.3, O).astype(np.float32)
    rho_b = rs.normal(-2, 0.5, O).astype(np.float32)
    eps = rs.randn(S, O, C, 3, 3).astype(np.float32)
    eps_b = rs.randn(S, O).astype(np.float32)
    sig, sig_b = ts.sigma_from_rho(_t(rho)), ts.sigma_from_rho(_t(rho_b))
    if estimator == REPARAM:
        got = tconv.conv_draws(_t(x), _t(mu) + sig * _t(eps),
                               _t(mu_b) + sig_b * _t(eps_b), padding=1,
                               data_format="NHWC")
        want = jconv.sampled_conv_structured(
            _j(x), KEY, S, _j(mu), _j(rho), _j(mu_b), _j(rho_b), padding=1,
            eps_k=_j(eps), eps_b=_j(eps_b))
        _close(got, want, rel=1e-5)
        return
    salts = [ts.sign_salts(7, s) for s in range(S)]
    got = tconv.flipout_conv_draws(_t(x), _t(mu), _t(mu_b), sig * _t(eps),
                                   sig_b * _t(eps_b), salts, padding=1,
                                   data_format="NHWC")
    sign_in = ts.rademacher_lanes([a for a, _ in salts], (B, H, H, C),
                                  axis=3).reshape(B, H, H, S * C)
    sign_out = ts.rademacher_lanes([b for _, b in salts], (B, H, H, O),
                                   axis=3).reshape(B, H, H, S * O)
    want = jconv.flipout_conv_structured(
        _j(x), KEY, S, _j(mu), _j(rho), _j(mu_b), _j(rho_b), padding=1,
        eps_k=_j(eps), eps_b=_j(eps_b), sign_in=_j(sign_in.numpy()),
        sign_out=_j(sign_out.numpy()))
    _close(got, want, rel=1e-5)
    # lane s is the single NHWC forward of draw s under its salts
    for s in range(S):
        xs = x if shared else x[..., s * C:(s + 1) * C]
        one = tconv.flipout_conv_presampled(
            _t(xs), _t(mu), _t(mu_b), (sig * _t(eps))[s],
            (sig_b * _t(eps_b))[s], salts[s], padding=1, data_format="NHWC")
        torch.testing.assert_close(got[..., s * O:(s + 1) * O], one,
                                   rtol=1e-5, atol=1e-5)


# --- BatchNorm and the pools -------------------------------------------------


def _bn_twins(C):
    jm = jdnn.BatchNorm2d(C, data_format="NHWC")
    rs = np.random.RandomState(C)
    arrays = {"weight": rs.uniform(0.5, 1.5, C), "bias": rs.randn(C) * 0.1,
              "running_mean": rs.randn(C) * 0.1,
              "running_var": rs.uniform(0.5, 1.5, C),
              "num_batches_tracked": np.zeros((), np.int64)}
    arrays = {k: np.asarray(v, np.float32 if v.dtype != np.int64 else None)
              for k, v in arrays.items()}
    import_torch_state_dict(jm, arrays)
    tm = tdnn.BatchNorm2d(C, data_format="NHWC")
    load_jax_state(tm, arrays)
    return jm, tm


@pytest.mark.parametrize("draws", [None, 3])
@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_nhwc_matches_jax(draws, training):
    """Training and eval; under the draw axis each draw's block of the
    last axis by its own statistics and one EMA update from their average
    (JAX's structured branch; the port records through ``mc_forward``'s
    BatchNorm context), running statistics compared after the step."""
    C = 4
    jm, tm = _bn_twins(C)
    jm.training = training
    tm.train(training)
    x = np.random.RandomState(9).randn(3, 5, 5, (draws or 1) * C)
    x = (x * 2 + 1).astype(np.float32)
    if draws:
        jm._mc_structured = draws
        tm._mc_draws = draws
        with tmc._mc_batch_stats(tm, "ema"):
            got = tm(_t(x))
    else:
        got = tm(_t(x))
    want = jm(_j(x))
    _close(got, want)
    assert got.is_contiguous()
    for name in ("running_mean", "running_var"):
        _close(getattr(tm, name), getattr(jm, name)[...], rel=1e-5)
    assert int(tm.num_batches_tracked) == int(jm.num_batches_tracked[...])


@pytest.mark.parametrize("pool", ["max", "avg", "adaptive"])
def test_pools_match_jax_nhwc(pool):
    x = np.random.RandomState(3).randn(2, 8, 8, 5).astype(np.float32)
    if pool == "max":
        want = jF.max_pool_nd(_j(x), 3, 2, 1, data_format="NHWC")
        got = tF.max_pool_nd(_t(x), 3, 2, 1, data_format="NHWC")
        mod = tdnn.MaxPool2d(3, 2, 1, data_format="NHWC")(_t(x))
    elif pool == "avg":
        want = jF.avg_pool_nd(_j(x), 2, data_format="NHWC")
        got = tF.avg_pool_nd(_t(x), 2, data_format="NHWC")
        mod = got
    else:
        want = jF.adaptive_avg_pool_nd(_j(x), 1, data_format="NHWC")
        got = tF.adaptive_avg_pool_nd(_t(x), 1, data_format="NHWC")
        mod = tdnn.AdaptiveAvgPool2d(1, data_format="NHWC")(_t(x))
    _close(got, want, rel=1e-6)
    assert torch.equal(mod, got) and got.is_contiguous()
    if pool == "max":  # a QTensor's uint8 payload, pooled as it is
        from bayesian_torch_tpu.ops.qtensor import QTensor as JQTensor
        from bayesian_torch_tpu_torch.ops.qtensor import QTensor

        q = tq.quantize_uint8(_t(x), 0.05, 128)
        got = tF.max_pool_nd(QTensor(q, 0.05, 128), 3, 2, 1,
                             data_format="NHWC")
        want = jF.max_pool_nd(JQTensor(jnp.asarray(q.numpy()), 0.05, 128),
                              3, 2, 1, data_format="NHWC")
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))


# --- INT8 --------------------------------------------------------------------


@pytest.mark.parametrize("k,stride,pad,groups", [
    (3, 1, 1, 1), (3, 2, 1, 2), (1, 2, 0, 1), (1, 1, 0, 1), (7, 2, 3, 1)])
def test_qconv_nhwc_matches_jax(k, stride, pad, groups):
    rs = np.random.RandomState(k + stride)
    cin, cout = 8, 12
    x = rs.randint(0, 256, (2, 9, 9, cin)).astype(np.uint8)
    w = rs.randint(-128, 128, (cout, cin // groups, k, k)).astype(np.int8)
    b = rs.randn(cout).astype(np.float32)
    kw = dict(stride=stride, padding=pad, groups=groups)
    want = jq.qconv(jnp.asarray(x), 0.05, 120, jnp.asarray(w), 0.01,
                    jnp.asarray(b), 0.3, 128, data_format="NHWC", **kw)
    got = tq.qconv(torch.from_numpy(x), 0.05, 120, torch.from_numpy(w), 0.01,
                   torch.from_numpy(b), 0.3, 128, data_format="NHWC", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    first = tq.qconv(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), 0.05,
                     120, torch.from_numpy(w), 0.01, torch.from_numpy(b),
                     0.3, 128, **kw)
    assert torch.equal(first.permute(0, 2, 3, 1), got)
