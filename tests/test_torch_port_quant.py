"""CPU parity of the port's INT8 post-training-quantization path with the
JAX package: the int8 ops, K-F's plain version, QTensor, the observers,
``quantize()`` with BN folding, the quantized layers, ``prepare`` /
``convert`` on a narrow ResNet, ``mc_forward`` on a converted model and the
weight carry. Inputs are numpy arrays from fixed seeds.

Tolerances: the int8 arithmetic of both packages is the same sequence of
f32 operations (reciprocal multiplies, one f32 requantization multiplier,
round half to even), so integer outputs and requantized activations are
compared for equality. The exceptions state their reason where they occur.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch import nn

import tests._torch_port as tp
import bayesian_torch_tpu.nn as jdnn
from bayesian_torch_tpu.layers.base_variational_layer import Presampled
from bayesian_torch_tpu.ops import int8 as jq
from bayesian_torch_tpu.ops import qtensor as jqt
from bayesian_torch_tpu.utils.checkpoint import (_torch_key_for,
                                                 import_torch_state_dict)
from bayesian_torch_tpu_torch.ops import int8 as tq
from bayesian_torch_tpu_torch.ops import qtensor as tqt
from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(jax_out, torch_out):
    a, b = np.asarray(jax_out), torch_out.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                        a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# --- int8 primitives ------------------------------------------------------


@pytest.mark.parametrize("scale_kind", ["tensor", "float"])
def test_quantizers_match_jax_exactly(scale_kind):
    rs = np.random.RandomState(0)
    x = (rs.randn(4096) * 3).astype(np.float32)
    js = jq.symmetric_scale(jnp.asarray(x))
    ts = tq.symmetric_scale(_t(x))
    assert float(js) == float(ts)
    if scale_kind == "float":
        js = ts = 0.0371
    _equal(jq.quantize_int8(jnp.asarray(x), js), tq.quantize_int8(_t(x), ts))
    _equal(jq.quantize_uint8(jnp.asarray(x), 0.037, 120),
           tq.quantize_uint8(_t(x), 0.037, 120))
    _equal(jq.requantize_int8(jnp.asarray(x), 0.05, 3),
           tq.requantize_int8(_t(x), 0.05, 3))
    u = rs.randint(0, 256, 999).astype(np.uint8)
    _equal(jq.dequantize(jnp.asarray(u), 0.013, 117),
           tq.dequantize(_t(u), 0.013, 117))
    assert float(tq.symmetric_scale(torch.zeros(3))) == np.float32(0.1)


@pytest.mark.parametrize("dtype,a_zp,b_zp,out_zp", [
    ("int8", 0, 0, 0), ("int8", 0, 0, 5), ("uint8", 120, 128, 131)])
def test_qmul_qadd_match_jax_exactly(dtype, a_zp, b_zp, out_zp):
    rs = np.random.RandomState(1)
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    a = rs.randint(lo, hi, 5000).astype(dtype)
    b = rs.randint(lo, hi, 5000).astype(dtype)
    kw = dict(a_zp=a_zp, b_zp=b_zp)
    _equal(jq.qmul(jnp.asarray(a), 0.013, jnp.asarray(b), 0.021, 0.0017,
                   out_zp, out_dtype=getattr(jnp, dtype), **kw),
           tq.qmul(_t(a), 0.013, _t(b), 0.021, 0.0017, out_zp,
                   out_dtype=getattr(torch, dtype), **kw))
    _equal(jq.qadd(jnp.asarray(a), 0.013, jnp.asarray(b), 0.021, 0.03,
                   out_zp, out_dtype=getattr(jnp, dtype), **kw),
           tq.qadd(_t(a), 0.013, _t(b), 0.021, 0.03, out_zp,
                   out_dtype=getattr(torch, dtype), **kw))


@pytest.mark.parametrize("x_zp", [128, 117])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("w_scale_kind", ["float", "f32"])
def test_qlinear_matches_jax_xla_route(x_zp, bias, w_scale_kind):
    """K-F's plain version behind ``qlinear`` equals the JAX default (XLA)
    route bit for bit, with a Python-float weight scale and with an f32
    one (a frozen draw's scale, an f32 array in JAX)."""
    rs = np.random.RandomState(2)
    x = rs.randint(0, 256, (3, 70, 100)).astype(np.uint8)
    w = rs.randint(-128, 128, (30, 100)).astype(np.int8)
    b = rs.randn(30).astype(np.float32) if bias else None
    ws = 0.0123
    jws, tws = ((ws, ws) if w_scale_kind == "float"
                else (jnp.asarray(ws, jnp.float32), np.float32(ws)))
    want = jq.qlinear(jnp.asarray(x), 0.05, x_zp, jnp.asarray(w), jws,
                      None if b is None else jnp.asarray(b), 0.3, 128)
    got = tq.qlinear(_t(x), 0.05, x_zp, _t(w), tws,
                     None if b is None else _t(b), 0.3, 128)
    _equal(want, got)
    assert 0.05 < (np.asarray(want) == 0).mean() + \
        (np.asarray(want) == 255).mean() < 0.5  # the clamp is exercised


@pytest.mark.parametrize("k,stride,pad,dil,cin,cout", [
    (3, 1, 1, 1, 16, 32), (3, 2, 1, 1, 16, 32), (7, 2, 3, 1, 3, 16),
    (3, 1, 2, 2, 8, 8), (5, 1, 0, 1, 8, 8), (1, 2, 0, 1, 8, 12)])
@pytest.mark.parametrize("x_zp", [128, 100])
def test_qconv_im2col_matches_jax_xla_route(k, stride, pad, dil, cin, cout,
                                            x_zp):
    """The uint8 im2col + GEMM conv equals the JAX XLA conv route (its
    border correction included) bit for bit, NCHW, over the JAX
    ``TestIm2colQConv`` geometries and a strided 1x1."""
    rs = np.random.RandomState(k * 10 + stride)
    x = rs.randint(0, 256, (2, cin, 14, 14)).astype(np.uint8)
    w = rs.randint(-128, 128, (cout, cin, k, k)).astype(np.int8)
    b = rs.randn(cout).astype(np.float32)
    args = dict(stride=stride, padding=pad, dilation=dil)
    out_scale = 0.02 * k
    want = jq.qconv(jnp.asarray(x), 0.05, x_zp, jnp.asarray(w), 0.01,
                    jnp.asarray(b), out_scale, 128, **args)
    got = tq.qconv(_t(x), 0.05, x_zp, _t(w), 0.01, _t(b), out_scale, 128,
                   **args)
    _equal(want, got.contiguous())
    if k > 1:  # the channels-last view: the next conv reads it as is
        assert got.permute(0, 2, 3, 1).is_contiguous()


def test_qconv_unported_cases_raise():
    """Grouped and transposed int8 convs run (and equal the JAX route:
    ``tests/test_torch_port_int8_flipout.py`` holds them at every
    geometry); channels-last activations, refused until the port took
    ``data_format``, run too and equal the JAX route's NHWC conv bit for
    bit (``tests/test_torch_port_nhwc.py`` holds every geometry)."""
    rs = np.random.RandomState(5)
    x = rs.randint(0, 256, (1, 4, 5, 5)).astype(np.uint8)
    w = rs.randint(-128, 128, (4, 2, 3, 3)).astype(np.int8)
    for kw, w_ in ((dict(groups=2), w), (dict(transposed=True), w),
                   (dict(transposed=True, groups=2, stride=2,
                         output_padding=1), w)):
        _equal(jq.qconv(jnp.asarray(x), 0.1, 120, jnp.asarray(w_), 0.1, None,
                        0.2, 128, **kw),
               tq.qconv(_t(x), 0.1, 120, _t(w_), 0.1, None, 0.2, 128,
                        **kw).contiguous())
    xl = x.transpose(0, 2, 3, 1).copy()
    _equal(jq.qconv(jnp.asarray(xl), 0.1, 128, jnp.asarray(w), 0.1, None,
                    0.1, 128, groups=2, data_format="NHWC"),
           tq.qconv(_t(xl), 0.1, 128, _t(w), 0.1, None, 0.1, 128, groups=2,
                    data_format="NHWC"))


# --- K-F's plain version --------------------------------------------------


@pytest.fixture
def jax_pallas_qmatmul():
    old = jq.USE_PALLAS_QMATMUL
    jq.USE_PALLAS_QMATMUL = True
    yield
    jq.USE_PALLAS_QMATMUL = old


@pytest.mark.parametrize("M,K,N,xzp,bias", [
    (16, 32, 24, 128, True), (70, 100, 30, 117, True), (8, 256, 512, 140,
                                                          False)])
def test_kf_plain_matches_jax_pallas_kernel(jax_pallas_qmatmul, M, K, N,
                                            xzp, bias):
    """K-F's plain version against the JAX Pallas kernel in interpret
    mode: at most 1 quantum apart, because the Pallas kernel folds the
    zero-point correction and the bias into one f32 ``beta``, which moves
    some round-half ties (``tests/test_qmatmul_pallas.py``)."""
    rs = np.random.RandomState(3)
    x = rs.randn(M, K).astype(np.float32)
    w = (rs.randn(N, K) * 0.4).astype(np.float32)
    b = rs.randn(N).astype(np.float32) if bias else None
    ws = float(jq.symmetric_scale(jnp.asarray(w)))
    xq = jq.quantize_uint8(jnp.asarray(x), 0.05, xzp)
    wq = jq.quantize_int8(jnp.asarray(w), ws)
    want = np.asarray(jq.qlinear(xq, 0.05, xzp, wq, ws,
                                 None if b is None else jnp.asarray(b), 0.1,
                                 128)).astype(int)
    args = kf.requant_args(_t(wq), xzp, 0.05, ws,
                           None if b is None else _t(b), 0.1)
    got = kf.qmatmul_requant_plain(_t(xq), _t(wq), *args, 128).numpy()
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got != want).mean() < 0.02


def test_kf_wrapper_checks_and_counts():
    x = torch.zeros((4, 8), dtype=torch.uint8)
    w = torch.zeros((3, 8), dtype=torch.int8)
    before = kf.qmatmul_requant.launches
    out = kf.qmatmul_requant(x, 0.1, 128, w, 0.1, None, 0.1, 128)
    assert out.dtype == torch.uint8 and out.shape == (4, 3)
    assert torch.equal(out, torch.full((4, 3), 128, dtype=torch.uint8))
    assert kf.qmatmul_requant.launches == before  # the plain version ran
    with pytest.raises(ValueError, match="uint8"):
        kf.qmatmul_requant(x.float(), 0.1, 128, w, 0.1, None, 0.1, 128)
    with pytest.raises(ValueError, match=r"\(N, K\)"):
        kf.qmatmul_requant(x, 0.1, 128, w[:, :4], 0.1, None, 0.1, 128)
    with pytest.raises(ValueError, match="bias"):
        kf.qmatmul_requant(x, 0.1, 128, w, 0.1, torch.zeros(2), 0.1, 128)


# --- QTensor and the functional ops ---------------------------------------


@pytest.mark.parametrize("residual", [False, True])
def test_qtensor_ops_match_jax(monkeypatch, residual):
    monkeypatch.setattr(jqt, "INT8_RESIDUAL_ADD", residual)
    monkeypatch.setattr(tqt, "INT8_RESIDUAL_ADD", residual)
    rs = np.random.RandomState(4)
    a = rs.randint(0, 256, (2, 3, 5, 5)).astype(np.uint8)
    b = rs.randint(0, 256, (2, 3, 5, 5)).astype(np.uint8)
    ja, jb = jqt.QTensor(jnp.asarray(a), 0.1, 128), \
        jqt.QTensor(jnp.asarray(b), 0.1, 128)
    ta, tb = tqt.QTensor(_t(a), 0.1, 128), tqt.QTensor(_t(b), 0.1, 128)
    _equal((ja + jb).q, (ta + tb).q)            # exact uint8 add
    _equal(jqt.relu(ja).q, tqt.relu(ta).q)
    _equal(ja.requantize(0.07, 120).q, ta.requantize(0.07, 120).q)
    _equal(ja.add_q(jb, 0.3, 100).q, ta.add_q(tb, 0.3, 100).q)
    jc, tc = jqt.QTensor(jnp.asarray(b), 0.05, 120), \
        tqt.QTensor(_t(b), 0.05, 120)
    mixed_j, mixed_t = ja + jc, ta + tc         # scales differ
    if residual:
        _equal(mixed_j.q, mixed_t.q)
        assert (mixed_t.scale, mixed_t.zp) == (mixed_j.scale, mixed_j.zp)
    else:
        _equal(mixed_j, mixed_t)                # f32 add
    x = rs.randn(2, 3, 5, 5).astype(np.float32)
    _equal(jnp.asarray(x) + ja, _t(x) + ta)     # __radd__
    _equal(ja + jnp.asarray(x), ta + _t(x))
    assert (0 + ta) is ta


def test_pools_take_qtensors():
    from bayesian_torch_tpu.nn import functional as jF
    from bayesian_torch_tpu_torch.nn import functional as tF
    rs = np.random.RandomState(5)
    a = rs.randint(0, 256, (2, 3, 9, 9)).astype(np.uint8)
    ja, ta = jqt.QTensor(jnp.asarray(a), 0.1, 7), tqt.QTensor(_t(a), 0.1, 7)
    jm, tm = jF.max_pool_nd(ja, 3, 2, 1), tF.max_pool_nd(ta, 3, 2, 1)
    _equal(jm.q, tm.q)                          # exact: max is monotonic
    assert (tm.scale, tm.zp) == (0.1, 7)
    # average pools dequantize; the f32 sums may differ in order (1 ulp)
    np.testing.assert_allclose(
        np.asarray(jF.adaptive_avg_pool_nd(ja, 1)),
        tF.adaptive_avg_pool_nd(ta, 1).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jF.avg_pool_nd(ja, 3, 2, 1)),
                               tF.avg_pool_nd(ta, 3, 2, 1).numpy(),
                               rtol=1e-6, atol=1e-6)
    x = torch.from_numpy(rs.randn(2, 3, 9, 9).astype(np.float32))
    assert torch.equal(tF.max_pool_nd(x, 3, 2, 1),
                       torch.nn.functional.max_pool2d(x, 3, 2, 1))


def test_batchnorm_dequantizes_a_qtensor():
    from bayesian_torch_tpu_torch.layers import BatchNorm2dLayer
    bn = BatchNorm2dLayer(3, generator=torch.Generator().manual_seed(0))
    bn.eval()
    qt = tqt.QTensor(torch.randint(0, 256, (2, 3, 4, 4), dtype=torch.uint8),
                     0.1, 128)
    assert torch.equal(bn(qt), bn(qt.dequantize()))
    out, kl = bn((qt, 0.0))
    assert torch.equal(out, bn(qt.dequantize())) and kl == 0


def test_scale_and_quantized_tensor_helpers_match_jax():
    jb = importlib.import_module("bayesian_torch_tpu.models.bnn_to_qbnn")
    tb = importlib.import_module("bayesian_torch_tpu_torch.models.bnn_to_qbnn")
    x = (np.random.RandomState(6).randn(7, 5) * 4).astype(np.float32)
    assert tb.get_scale_and_zero_point(_t(x)) == \
        jb.get_scale_and_zero_point(jnp.asarray(x))
    jt, tt = jb.get_quantized_tensor(jnp.asarray(x)), \
        tb.get_quantized_tensor(_t(x))
    _equal(jt.q, tt.q)
    assert (tt.scale, tt.zp) == (jt.scale, jt.zp)


# --- observers ------------------------------------------------------------


def test_minmax_observer_qparams_match_jax():
    from bayesian_torch_tpu.quantization import observers as jo
    from bayesian_torch_tpu_torch.quantization import observers as to
    rs = np.random.RandomState(7)
    batches = [(rs.randn(50) * s + o).astype(np.float32)
               for s, o in ((1.0, 0.5), (3.0, -1.0), (0.1, 2.0))]
    for dtype in ("qint8", "quint8"):
        jo_, to_ = jo.MinMaxObserver(dtype), to.MinMaxObserver(dtype)
        assert jo_.calculate_qparams() == to_.calculate_qparams()
        assert not to_.observed
        for b in batches:
            jo_(jnp.asarray(b))
            assert torch.equal(to_(_t(b)), _t(b))
        assert to_.observed
        assert jo_.calculate_qparams() == to_.calculate_qparams()
    fac = to.MinMaxObserver.with_args(dtype="quint8")
    assert fac().dtype == "quint8"
    with pytest.raises(ValueError):
        to.MinMaxObserver("int4")


def test_prepare_checks_qconfig_slots():
    from bayesian_torch_tpu_torch.layers import LinearReparameterization
    from bayesian_torch_tpu_torch.quantization import (MinMaxObserver,
                                                       QConfig, prepare)
    lin = LinearReparameterization(4, 3)
    swapped = QConfig(activation=MinMaxObserver.with_args(dtype="qint8"),
                      weight=MinMaxObserver.with_args(dtype="quint8"))
    with pytest.raises(ValueError, match="QConfig.weight"):
        prepare(lin, swapped)
    prepare(lin)
    assert lin.quant_prepare and len(lin.qint_quant) == 5 \
        and len(lin.quint_quant) == 2


# --- quantize() and the quantized layers ----------------------------------


def _layer_pair(kind, bias, seed):
    """(jax layer, torch layer) holding the same random posterior."""
    from bayesian_torch_tpu import layers as JL
    from bayesian_torch_tpu_torch import layers as TL
    if kind == "conv":
        jl = JL.Conv2dReparameterization(4, 6, 3, padding=1, bias=bias,
                                         rngs=nnx.Rngs(seed))
        tl = TL.Conv2dReparameterization(4, 6, 3, padding=1, bias=bias)
    else:
        jl = JL.LinearReparameterization(12, 7, bias=bias,
                                         rngs=nnx.Rngs(seed))
        tl = TL.LinearReparameterization(12, 7, bias=bias)
    arrays = tp.random_state(tp.jax_arrays(jl), seed=seed)
    import_torch_state_dict(jl, arrays)
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
    load_jax_state(tl, arrays)
    return jl, tl


def _bn_pair(seed):
    from bayesian_torch_tpu.layers import BatchNorm2dLayer as JBN
    from bayesian_torch_tpu_torch.layers import BatchNorm2dLayer as TBN
    jbn, tbn = JBN(6), TBN(6)
    arrays = tp.random_state(tp.jax_arrays(jbn), seed=seed)
    import_torch_state_dict(jbn, arrays)
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
    load_jax_state(tbn, arrays)
    return jbn, tbn


_QBUFFERS = ("quantized_mu_weight", "quantized_sigma_weight",
             "mu_weight_scale", "sigma_weight_scale", "quantized_mu_bias",
             "quantized_sigma_bias")


def _assert_quant_state_close(port_state, jax_arrays):
    """The port's own ``quantize()`` of a posterior against JAX's, both
    taking softplus(rho) from their own exp and log1p (torch's and XLA's
    differ in the last ulp for about 1 % of elements): int8 tensors within
    one quantum, the rare place where such an ulp crosses a rounding
    boundary; scales and biases within 2e-6 relative."""
    for key, value in port_state.items():
        if key.rsplit(".", 1)[-1] not in _QBUFFERS:
            continue
        got, want = value.numpy(), np.asarray(jax_arrays[key])
        assert got.dtype == want.dtype, key
        if got.dtype == np.int8:
            d = np.abs(got.astype(int) - want.astype(int))
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, key
        else:
            np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-9,
                                       err_msg=key)


@pytest.mark.parametrize("kind,bias,fold", [
    ("conv", False, False), ("conv", True, False), ("conv", False, True),
    ("conv", True, True), ("linear", True, False)])
@pytest.mark.parametrize("sigma", ["exact", "softplus"])
def test_quantize_matches_jax(monkeypatch, kind, bias, fold, sigma):
    """``quantize()`` with and without BN folding. With sigma taken as
    |rho| in both packages (an exact operation) the int8 weights, scales
    and biases equal JAX's bit for bit; with the real softplus they agree
    as ``_assert_quant_state_close`` states."""
    import bayesian_torch_tpu.layers.quantized_base as jqb
    import bayesian_torch_tpu_torch.layers.quantized_base as tqb
    jb = importlib.import_module("bayesian_torch_tpu.models.bnn_to_qbnn")
    tb = importlib.import_module("bayesian_torch_tpu_torch.models.bnn_to_qbnn")
    if sigma == "exact":
        monkeypatch.setattr(jqb, "sigma_from_rho", jnp.abs)
        monkeypatch.setattr(tqb, "sigma_from_rho", torch.abs)
    jl, tl = _layer_pair(kind, bias, seed=8)
    if fold:
        jbn, tbn = _bn_pair(seed=9)
        jqz, tqz = jb.batch_norm_folding(jl, jbn), \
            tb.batch_norm_folding(tl, tbn)
    elif kind == "conv":
        jqz, tqz = jb.qbnn_conv_layer(jl), tb.qbnn_conv_layer(tl)
    else:
        jqz, tqz = jb.qbnn_linear_layer(jl), tb.qbnn_linear_layer(tl)
    state = tqz.state_dict()
    assert set(state) == {name for name in _QBUFFERS
                          if getattr(jqz, name) is not None}
    assert not list(tqz.parameters())  # the float posterior is gone
    jarrays = {name: np.asarray(getattr(jqz, name)[...]) for name in state}
    if sigma == "exact":
        for name, value in state.items():
            _equal(jarrays[name], value)
        assert tqz._mu_scale_f == jqz._mu_scale_f
        assert tqz._sigma_scale_f == jqz._sigma_scale_f
    else:
        _assert_quant_state_close(state, jarrays)
    assert tqz.bias == jqz.bias and tqz.kl_loss() == 0.0


class _JaxHolder(nnx.Module):
    def __init__(self, layer):
        self.l = layer


def _quantized_pair(kind, calibrated, seed):
    """A quantized layer in each package with the same state: prepared,
    calibrated (through JAX) or not, converted, and JAX's int8 state and
    quant_dict carried into the port's layer."""
    from bayesian_torch_tpu.quantization import convert as jconvert
    from bayesian_torch_tpu.quantization import prepare as jprepare
    from bayesian_torch_tpu_torch.quantization import convert, prepare
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state
    jl, tl = _layer_pair(kind, True, seed)
    jholder, tholder = _JaxHolder(jl), nn.ModuleDict(dict(l=tl))
    jprepare(jholder), prepare(tholder)
    rs = np.random.RandomState(seed)
    shape = (2, 4, 6, 6) if kind == "conv" else (5, 12)
    if calibrated:
        for _ in range(2):
            jl(jnp.asarray(rs.randn(*shape).astype(np.float32)))
    jconvert(jholder), convert(tholder)
    load_jax_quant_state(tholder, *_jax_quant_state(jholder))
    return jholder.l, tholder["l"], shape


@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("calibrated", [False, True])
def test_quantized_layer_forward_with_injected_eps(kind, calibrated):
    """The weight build on injected eps and the layer's forward on that
    draw (pinned as a frozen draw) equal JAX's exactly, calibrated and
    uncalibrated."""
    jl, tl, shape = _quantized_pair(kind, calibrated, seed=10)
    assert (jl.quant_dict is not None) == calibrated
    assert tl.quant_dict == jl.quant_dict
    rs = np.random.RandomState(11)
    eps = rs.randn(*jl.quantized_mu_weight.shape).astype(np.float32)
    eps_b = rs.randn(*jl.quantized_mu_bias.shape).astype(np.float32)
    jw, js, jbias = jl._sampled_qweight_reparam(6 / 255, eps=jnp.asarray(eps),
                                                eps_b=jnp.asarray(eps_b))
    tw, ts, tbias = tl._sampled_qweight_reparam(6 / 255, eps=_t(eps),
                                                eps_b=_t(eps_b))
    _equal(jw, tw)
    _equal(jbias, tbias)
    assert ts == js
    jl._frozen_w, jl._frozen_wscale = Presampled(jw), \
        Presampled(jnp.asarray(js))
    jl._frozen_bias = Presampled(jbias)
    tl.register_buffer("_frozen_w", tw)
    tl.register_buffer("_frozen_wscale", torch.tensor(ts))
    tl.register_buffer("_frozen_bias", tbias)
    tl._refresh_scales()
    x = (rs.randn(*shape) * 2).astype(np.float32)
    jout, jkl = jl(jnp.asarray(x))
    tout, tkl = tl(_t(x))
    _equal(jout, tout)
    assert tkl == 0 and jkl == 0
    tl.q_output = True
    qt = tl(_t(x), return_kl=False)
    assert isinstance(qt, tqt.QTensor) and qt.q.dtype == torch.uint8
    assert torch.equal(qt.dequantize(), tout)


def test_quantized_layer_draws_differ_and_stay_on_device():
    tb = importlib.import_module("bayesian_torch_tpu_torch.models.bnn_to_qbnn")
    _, tl = _layer_pair("conv", True, seed=12)
    ql = tb.qbnn_conv_layer(tl)
    x = torch.randn(2, 4, 6, 6)
    a, _ = ql(x)
    b, _ = ql(x)
    assert not torch.equal(a, b)
    assert ql.generator is tl.generator  # carried like the JAX rngs


# --- narrow ResNet twins: prepare -> calibrate -> convert ----------------


class JaxQTiny(nnx.Module):
    """Stem conv/bn/relu/maxpool, two Bottlenecks (one downsampling),
    global average pool, head: the ResNet's QTensor flow at small size,
    with either estimator's layers."""

    def __init__(self, rngs, estimator=tp.REPARAM):
        import bayesian_torch_tpu.layers as layers
        from bayesian_torch_tpu.layers import BatchNorm2dLayer
        from bayesian_torch_tpu.models._large_resnet import Bottleneck

        conv = getattr(layers, f"Conv2d{estimator}")
        self.conv1 = conv(3, 16, 3, padding=1, bias=False, rngs=rngs)
        self.bn1 = jdnn.BatchNorm2d(16)
        self.maxpool = jdnn.MaxPool2d(3, stride=2, padding=1)
        down = jdnn.Sequential(
            conv(16, 32, 1, stride=2, bias=False, rngs=rngs),
            BatchNorm2dLayer(32))
        self.layer1 = jdnn.Sequential(
            Bottleneck(16, 8, 2, down, estimator=estimator, rngs=rngs),
            Bottleneck(32, 8, estimator=estimator, rngs=rngs))
        self.avgpool = jdnn.AdaptiveAvgPool2d(1)
        self.fc = getattr(layers, f"Linear{estimator}")(32, 10, rngs=rngs)

    def __call__(self, x):
        from bayesian_torch_tpu.nn import functional as F
        out, kl_sum = self.conv1(x)
        out = self.maxpool(F.relu(self.bn1(out)))
        for block in self.layer1:
            out, kl = block(out)
            kl_sum = kl_sum + kl
        out = self.avgpool(out)
        out, kl = self.fc(out.reshape(out.shape[0], -1))
        return out, kl_sum + kl


class TorchQTiny(nn.Module):
    def __init__(self, generator=None, estimator=tp.REPARAM):
        super().__init__()
        import bayesian_torch_tpu_torch.layers as layers
        from bayesian_torch_tpu_torch.layers import BatchNorm2dLayer
        from bayesian_torch_tpu_torch.models._large_resnet import Bottleneck
        from bayesian_torch_tpu_torch.nn import (AdaptiveAvgPool2d,
                                                 BatchNorm2d, MaxPool2d,
                                                 Sequential)

        g = generator
        conv = getattr(layers, f"Conv2d{estimator}")
        self.conv1 = conv(3, 16, 3, padding=1, bias=False, generator=g)
        self.bn1 = BatchNorm2d(16)
        self.maxpool = MaxPool2d(3, stride=2, padding=1)
        down = Sequential(
            conv(16, 32, 1, stride=2, bias=False, generator=g),
            BatchNorm2dLayer(32))
        self.layer1 = nn.Sequential(
            Bottleneck(16, 8, 2, down, estimator=estimator, generator=g),
            Bottleneck(32, 8, estimator=estimator, generator=g))
        self.avgpool = AdaptiveAvgPool2d(1)
        self.fc = getattr(layers, f"Linear{estimator}")(32, 10, generator=g)

    def forward(self, x):
        from bayesian_torch_tpu_torch.nn import functional as F
        out, kl_sum = self.conv1(x)
        out = self.maxpool(F.relu(self.bn1(out)))
        for block in self.layer1:
            out, kl = block(out)
            kl_sum = kl_sum + kl
        out = self.avgpool(out)
        out, kl = self.fc(out.reshape(out.shape[0], -1))
        return out, kl_sum + kl


def _images(seed, n=2):
    return np.random.RandomState(seed).randn(n, 3, 32, 32).astype(np.float32)


def _qtiny_twins(seed=0, mu_scale=1.0, estimator=tp.REPARAM):
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
    jm = JaxQTiny(nnx.Rngs(params=seed, noise=seed + 1), estimator)
    arrays = tp.random_state(tp.jax_arrays(jm), seed=seed)
    for key in arrays:
        if key.endswith(("mu_kernel", "mu_weight")):
            arrays[key] = arrays[key] * np.float32(mu_scale)
    import_torch_state_dict(jm, arrays)
    tp.set_jax_eval(jm)
    tm = TorchQTiny(torch.Generator().manual_seed(seed), estimator)
    load_jax_state(tm, arrays)
    tm.eval()
    return jm, tm


def _jax_quant_state(jm):
    """(arrays, quant_dicts) of a converted JAX model: its Param,
    BatchStat and QuantParam state, its frozen draws, and each quantized
    layer's quant_dict, under torch-style names."""
    from bayesian_torch_tpu.layers.quantized_base import _QuantizedLayerBase
    arrays = tp.jax_arrays(jm)
    frozen = nnx.state(jm, Presampled)
    for path, var in nnx.to_flat_state(frozen):
        arrays[_torch_key_for(path)] = np.asarray(var[...])
    quant_dicts = {_torch_key_for(path): mod.quant_dict
                   for path, mod in nnx.iter_modules(jm)
                   if isinstance(mod, _QuantizedLayerBase)}
    return arrays, quant_dicts


CASES = {
    # (calibrated, fuse_conv_bn, quantize_activations, mu_scale)
    "calibrated-fused-uint8": (True, True, True, 1.0),
    # the JAX bench's configuration: every tensor at scale 0.2, zp 128;
    # posteriors shrunk so activations stay inside the +-25.4 range
    "uncalibrated-fused-uint8": (False, True, True, 0.3),
    "calibrated-bn-f32": (True, False, False, 1.0),
    # uint8 conv outputs into the float BN, which dequantizes them
    "calibrated-bn-uint8": (True, False, True, 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_calibrate_convert_matches_jax(case):
    """The whole converted narrow ResNet: the port's own ``quantize()``
    gives JAX's int8 state exactly; with JAX's quant_dicts and frozen
    draws carried across, the logits agree.

    Tolerance: up to the global average pool the int8 flow is integer
    arithmetic and the same f32 operations in both packages; the pool's f32
    sum may run in another order (1 ulp), and with float BN
    (``calibrated-bn-f32``) the two eval-BN formulas may differ in the last
    ulp before each conv quantizes its input. Such an ulp can move a value
    across a rounding boundary, which changes a logit by a few head-output
    quanta where it happens: held to 3 quanta, and at least 90 % of the
    logits equal. (Measured on the CPU: all equal.)"""
    from bayesian_torch_tpu.quantization import (
        convert as jconvert, freeze_quantized_draws as jfreeze,
        prepare as jprepare)
    from bayesian_torch_tpu_torch.quantization import convert, prepare
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state
    calibrated, fuse, qa, mu_scale = CASES[case]
    jm, tm = _qtiny_twins(seed=13, mu_scale=mu_scale)
    jprepare(jm), prepare(tm)
    if calibrated:
        for i in range(3):
            jm(jnp.asarray(_images(20 + i)))
    jconvert(jm, fuse_conv_bn=fuse, quantize_activations=qa)
    convert(tm, fuse_conv_bn=fuse, quantize_activations=qa)
    arrays, quant_dicts = _jax_quant_state(jm)
    # the port's own conversion of the same posterior gives JAX's state
    state = tm.state_dict()
    assert set(state) == set(arrays)
    _assert_quant_state_close(state, arrays)
    assert isinstance(tm.bn1, nn.Identity) == fuse
    jfreeze(jm)
    arrays, quant_dicts = _jax_quant_state(jm)
    assert any(k.endswith("._frozen_w") for k in arrays)
    assert all((d is not None) == calibrated for d in quant_dicts.values())
    load_jax_quant_state(tm, arrays, quant_dicts)
    x = _images(30)
    want = np.asarray(jm(jnp.asarray(x))[0])
    got, kl = tm(_t(x))
    got = got.numpy()
    assert got.shape == (2, 10) and float(kl) == 0.0
    assert np.abs(want).max() > 0.5  # a signal, not all zeros
    head_q = tm.fc.quant_dict[4]["scale"] if calibrated else 0.2
    diff = np.abs(got - want)
    assert diff.max() <= 3 * head_q * (1 + 1e-6), diff.max() / head_q
    assert (diff == 0).mean() >= 0.9


def test_qtensor_flow_matches_f32_flow():
    """The port's twin of ``test_qresnet_qtensor_flow``: with activations
    inside the representable range, the uint8 flow (QTensor between
    convs) and the f32 round-trip flow give the same logits, and the head
    returns a tensor. Frozen draws pin the same weights in both."""
    from bayesian_torch_tpu_torch.quantization import (
        convert, freeze_quantized_draws, prepare)
    outs = []
    for qa in (False, True):
        _, tm = _qtiny_twins(seed=14, mu_scale=0.3)
        prepare(tm)
        convert(tm, fuse_conv_bn=True, quantize_activations=qa)
        assert tm.layer1[0].conv1.q_output == qa
        assert tm.fc.q_output is False
        freeze_quantized_draws(tm)  # same generators: the same draws
        out, _ = tm(_t(_images(31)))
        assert isinstance(out, torch.Tensor)
        outs.append(out)
    assert outs[0].abs().max() > 0.5  # a signal, not all zeros
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)


def test_unported_conversions_raise():
    """What ``bnn_to_qbnn`` still refuses: a per-channel observer in a
    per-tensor ``quant_dict`` slot. A Bayesian LSTM converts (its ``ih``
    and ``hh`` quantized in place; ``test_torch_port_lstm.py`` holds it
    against JAX), and ``quantize_batchnorm=True`` converts
    (``QuantizedBatchNorm2d``)."""
    from bayesian_torch_tpu_torch.layers import (
        BatchNorm2dLayer, LSTMReparameterization, QuantizedBatchNorm2d,
        QuantizedLinearReparameterization)
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn
    from bayesian_torch_tpu_torch.quantization import (
        MinMaxObserver, PerChannelMinMaxObserver, QConfig, prepare)

    rnn = nn.ModuleDict(dict(rnn=LSTMReparameterization(3, 4)))
    bnn_to_qbnn(rnn)
    assert type(rnn["rnn"]) is LSTMReparameterization
    assert type(rnn["rnn"].hh) is QuantizedLinearReparameterization
    _, tm = _qtiny_twins(seed=15)
    bnn_to_qbnn(tm, quantize_batchnorm=True)
    assert type(tm.bn1) is QuantizedBatchNorm2d
    assert isinstance(tm.layer1[0].downsample[1], BatchNorm2dLayer)
    _, tm = _qtiny_twins(seed=15)
    per_channel = QConfig(
        activation=MinMaxObserver.with_args(dtype="quint8"),
        weight=PerChannelMinMaxObserver.with_args(dtype="qint8"))
    prepare(tm, per_channel)
    with torch.no_grad():
        tm(_t(_images(19)))
    with pytest.raises(ValueError, match="per tensor"):
        bnn_to_qbnn(tm)


# --- mc_forward, serving and the weight carry -----------------------------


def _converted_tiny(seed=16):
    from bayesian_torch_tpu_torch.quantization import convert, prepare
    _, tm = _qtiny_twins(seed=seed, mu_scale=0.3)
    prepare(tm)
    with torch.no_grad():
        for i in range(2):
            tm(_t(_images(40 + i)))
    convert(tm, fuse_conv_bn=True, quantize_activations=True)
    return tm


def test_mc_forward_on_a_converted_model():
    from bayesian_torch_tpu_torch.parallel import mc_forward
    from bayesian_torch_tpu_torch.parallel.mc import _presample_layers
    from bayesian_torch_tpu_torch.quantization import (
        freeze_quantized_draws, unfreeze_quantized_draws)
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import get_kl_loss
    tm = _converted_tiny()
    assert all(layer.quant_dict is not None
               for layer in tm.modules() if hasattr(layer, "quant_dict"))
    # nothing left to train, and no KL: the optimizer and the ELBO's KL
    # term see no quantized layer
    assert list(tm.parameters()) == [] and get_kl_loss(tm) == 0.0
    # the presample builds each layer's int8 weights for all 3 draws
    records = _presample_layers(tm, 3)
    assert len(records) == 9
    for layer, attrs in records:
        assert attrs["_presampled_qw"].shape == \
            (3,) + tuple(layer.quantized_mu_weight.shape)
        assert attrs["_presampled_qnscale"] == [6 / 255] * 3
    x = _t(_images(50))
    outs, kl = mc_forward(tm, x, 3)
    assert outs.shape == (3, 2, 10) and float(kl) == 0.0
    assert not torch.equal(outs[0], outs[1])   # each draw builds anew
    mean = mc_forward(tm, x, 3, reduce="mean", return_kl=False)
    assert mean.shape == (2, 10) and torch.isfinite(mean).all()
    assert freeze_quantized_draws(tm) == 9  # 8 convs and the head
    frozen = mc_forward(tm, x, 3, return_kl=False)
    assert torch.equal(frozen[0], frozen[1]) and torch.equal(frozen[1],
                                                             frozen[2])
    assert torch.equal(frozen[0], mc_forward(tm, x, 1, return_kl=False)[0])
    assert unfreeze_quantized_draws(tm) == 9
    assert not any(k.endswith("_frozen_w") for k in tm.state_dict())
    again = mc_forward(tm, x, 2, return_kl=False)
    assert not torch.equal(again[0], again[1])
    # its quantized layers take the draw axis (test_torch_port_int8_draws
    # .py), but a converted model has nothing to train: "auto" keeps the
    # draw loop for it in training mode too
    from bayesian_torch_tpu_torch.parallel import mc as tmc
    tm.train()
    assert tmc._draw_axis_refusal(tm) is None
    assert tmc._resolve_emission(tm, 3, True) == "scan"
    outs, _ = mc_forward(tm, x, 3)
    assert outs.shape == (3, 2, 10) and not torch.equal(outs[0], outs[1])


def test_weight_carry_round_trip():
    """A converted, frozen port model's state (int8 weights, scales, frozen
    draws) and quant_dicts, carried into a fresh converted model through
    ``load_jax_quant_state``, give the same logits; the scales' host
    copies are rebuilt, by ``load_state_dict`` too."""
    from bayesian_torch_tpu_torch.quantization import (
        convert, freeze_quantized_draws, prepare)
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state
    src = _converted_tiny(seed=17)
    freeze_quantized_draws(src)
    x = _t(_images(60))
    want, _ = src(x)
    arrays = {k: v.numpy() for k, v in src.state_dict().items()}
    quant_dicts = {name: mod.quant_dict for name, mod in src.named_modules()
                   if hasattr(mod, "quant_dict")}
    _, dst = _qtiny_twins(seed=18, mu_scale=0.3)
    prepare(dst)
    convert(dst, fuse_conv_bn=True, quantize_activations=True)
    load_jax_quant_state(dst, arrays, quant_dicts)
    assert dst.fc._mu_scale_f == src.fc._mu_scale_f
    assert dst.conv1._frozen_wscale_f == src.conv1._frozen_wscale_f
    assert torch.equal(dst(x)[0], want)
    dst.fc._mu_scale_f = dst.conv1._frozen_wscale_f = None
    dst.load_state_dict(src.state_dict())
    assert dst.fc._mu_scale_f == src.fc._mu_scale_f
    assert dst.conv1._frozen_wscale_f == src.conv1._frozen_wscale_f
    with pytest.raises(ValueError, match="not a quantized layer"):
        load_jax_quant_state(dst, {"avgpool._frozen_w": np.zeros(1)})
