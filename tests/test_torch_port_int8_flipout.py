"""CPU parity of the port's INT8 remainder with the JAX package: grouped
and transposed ``qconv``, the quantized Flipout layers and the transposed
reparameterization ones, the legacy ``ao`` classes, the per-channel and
histogram observers, ``QuantizedBatchNorm2d``, the narrow Flipout ResNet
through ``prepare`` -> calibrate -> ``convert``, the Flipout ``qresnet``
factories and the quantized presample. Inputs are numpy arrays from fixed
seeds.

Tolerances: both packages run the same integer and f32 operations on the
int8 path (K-F's plain version equals the JAX XLA route), so int8 and
uint8 results are compared for equality, and each exception states its
reason. The Flipout signs are injected: the port takes them as arguments,
and on the JAX side the test replaces ``ops.sampling.rademacher_fused``
for the call, as the zoo tests do; nothing in the JAX package changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch import nn

import tests._torch_port as tp
import bayesian_torch_tpu.ops.sampling as jsampling
from bayesian_torch_tpu.ops import int8 as jq
from bayesian_torch_tpu.ops import qtensor as jqt
from bayesian_torch_tpu_torch.ops import int8 as tq
from bayesian_torch_tpu_torch.ops import qtensor as tqt
from tests.test_torch_port_quant import (_assert_quant_state_close, _equal,
                                         _images, _jax_quant_state,
                                         _qtiny_twins, _t)

torch.set_num_threads(1)


# --- grouped and transposed qconv ------------------------------------------

QCONV_CASES = {
    "g2": dict(nd=2, cin=8, cout=12, k=3, padding=1, groups=2),
    "g4-stride2": dict(nd=2, cin=8, cout=8, k=3, stride=2, padding=1,
                       groups=4),
    "depthwise-dil2": dict(nd=2, cin=8, cout=8, k=3, padding=2, dilation=2,
                           groups=8),
    "g2-1d": dict(nd=1, cin=6, cout=4, k=5, stride=2, padding=2, groups=2),
    "t1d-s2-op1": dict(nd=1, cin=6, cout=4, k=3, stride=2, padding=1,
                       output_padding=1, transposed=True),
    "t2d-k4s2p1": dict(nd=2, cin=8, cout=6, k=4, stride=2, padding=1,
                       transposed=True),
    "t2d-dil2-g2-op1": dict(nd=2, cin=8, cout=6, k=3, stride=2, dilation=2,
                            groups=2, output_padding=1, transposed=True),
    "t3d-s2-op1": dict(nd=3, cin=4, cout=4, k=3, stride=2, padding=1,
                       output_padding=1, transposed=True),
    # padding above d*(k-1): the equivalent conv's input is cropped
    "t2d-crop": dict(nd=2, cin=4, cout=6, k=3, padding=3, transposed=True),
}


@pytest.mark.parametrize("case", list(QCONV_CASES))
@pytest.mark.parametrize("x_zp,bias,w_scale_kind", [
    (128, False, "float"), (117, True, "f32")])
def test_qconv_grouped_and_transposed_match_jax(case, x_zp, bias,
                                                w_scale_kind):
    """Grouped convs (one K-F GEMM per group) and transposed ones (the
    zero-point-inserted stride-1 conv) equal the JAX XLA route bit for
    bit, with a Python-float and an f32 weight scale."""
    kw = dict(QCONV_CASES[case])
    nd, cin, cout, k = (kw.pop(n) for n in ("nd", "cin", "cout", "k"))
    g = kw.get("groups", 1)
    rs = np.random.RandomState(len(case) * 7 + x_zp)
    x = rs.randint(0, 256, (2, cin) + (7,) * nd).astype(np.uint8)
    wshape = ((cin, cout // g) if kw.get("transposed") else
              (cout, cin // g)) + (k,) * nd
    w = rs.randint(-128, 128, wshape).astype(np.int8)
    b = rs.randn(cout).astype(np.float32) if bias else None
    ws = 0.0123
    jws, tws = ((ws, ws) if w_scale_kind == "float"
                else (jnp.asarray(ws, jnp.float32), np.float32(ws)))
    # about 40 quanta per standard deviation of the accumulator
    out_scale = 0.05 * ws * 74 * 74 * (cin // g * k ** nd) ** 0.5 / 40
    want = jq.qconv(jnp.asarray(x), 0.05, x_zp, jnp.asarray(w), jws,
                    None if b is None else jnp.asarray(b), out_scale, 128,
                    **kw)
    got = tq.qconv(_t(x), 0.05, x_zp, _t(w), tws,
                   None if b is None else _t(b), out_scale, 128, **kw)
    _equal(want, got.contiguous())
    clamped = ((np.asarray(want) == 0) | (np.asarray(want) == 255)).mean()
    assert clamped < 0.5  # most outputs inside the range


# --- the quantized layers: Flipout, and the transposed reparameterization --

# float class: (constructor args, input shape); transposed ones also take
# output_padding=1 unless grouped
FLOAT = {
    "LinearReparameterization": ((12, 7), (5, 12)),
    "Conv2dReparameterization": ((4, 6, 3, 1, 1, 1, 2), (2, 4, 6, 6)),
    "LinearFlipout": ((12, 7), (5, 12)),
    "Conv1dFlipout": ((4, 6, 3, 1, 1), (2, 4, 9)),
    "Conv2dFlipout": ((4, 6, 3, 1, 1, 1, 2), (2, 4, 6, 6)),
    "Conv3dFlipout": ((4, 6, 3, 1, 1), (2, 4, 5, 5, 5)),
    "ConvTranspose1dFlipout": ((4, 6, 3, 2, 1), (2, 4, 7)),
    "ConvTranspose2dFlipout": ((4, 6, 4, 2, 1), (2, 4, 6, 6)),
    "ConvTranspose3dFlipout": ((4, 4, 3, 2, 1), (2, 4, 4, 4, 4)),
    "ConvTranspose1dReparameterization": ((4, 6, 3, 2, 1), (2, 4, 7)),
    "ConvTranspose2dReparameterization": ((4, 6, 4, 2, 1, 1, 2),
                                          (2, 4, 6, 6)),
    "ConvTranspose3dReparameterization": ((4, 4, 3, 2, 1), (2, 4, 4, 4, 4)),
}
# the twins without one in tests/test_torch_port_quant.py
LAYERS = [name for name in FLOAT if name.endswith("Flipout")
          or name.startswith("ConvTranspose")]


def _float_pair(name, seed, bias=True):
    """The float Bayesian layer in each package with the same random
    posterior (transposed ones with output_padding=1)."""
    from bayesian_torch_tpu import layers as JL
    from bayesian_torch_tpu.utils.checkpoint import import_torch_state_dict
    from bayesian_torch_tpu_torch import layers as TL
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
    args, _ = FLOAT[name]
    kw = dict(bias=bias)
    if "Transpose" in name and len(args) < 7:
        kw["output_padding"] = 1
    jl = getattr(JL, name)(*args, rngs=nnx.Rngs(seed), **kw)
    tl = getattr(TL, name)(*args, **kw)
    arrays = tp.random_state(tp.jax_arrays(jl), seed=seed)
    import_torch_state_dict(jl, arrays)
    load_jax_state(tl, arrays)
    return jl, tl


class _JaxHolder(nnx.Module):
    def __init__(self, layer):
        self.l = layer


def _converted_pair(name, calibrated, seed):
    """The quantized twin in each package: prepared, calibrated (both
    packages, two batches) or not, converted; JAX's int8 state, frozen
    draw (weight or perturbation) and quant_dict carried into the port's
    layer. Returns (jax layer, port layer, input shape, port quant_dict
    of its own calibration)."""
    from bayesian_torch_tpu.quantization import (
        convert as jconvert, freeze_quantized_draws as jfreeze,
        prepare as jprepare)
    from bayesian_torch_tpu_torch.quantization import convert, prepare
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state
    jl, tl = _float_pair(name, seed)
    jholder, tholder = _JaxHolder(jl), nn.ModuleDict(dict(l=tl))
    jprepare(jholder), prepare(tholder)
    shape = FLOAT[name][1]
    rs = np.random.RandomState(seed)
    if calibrated:
        for _ in range(2):
            x = rs.randn(*shape).astype(np.float32)
            jl(jnp.asarray(x))
            with torch.no_grad():
                tl(_t(x))
    jconvert(jholder), convert(tholder)
    own = tholder["l"].quant_dict
    # the port's own quantize() of the same posterior: JAX's state
    _assert_quant_state_close(
        {"l." + k: v for k, v in tholder["l"].state_dict().items()},
        tp.jax_arrays(jholder))
    jfreeze(jholder)
    load_jax_quant_state(tholder, *_jax_quant_state(jholder))
    return jholder.l, tholder["l"], shape, own


class _Signs:
    """A source of Rademacher signs, the same sequence for each package:
    call i gives the signs of ``np.random.RandomState(i)``."""

    def __init__(self):
        self.calls = 0

    def __call__(self, shape):
        rs = np.random.RandomState(self.calls)
        self.calls += 1
        return np.where(rs.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)

    def jax(self, _key, shape, dtype=jnp.float32):
        return jnp.asarray(self(shape), dtype)

    def torch(self, _salt, shape, dtype=torch.float32, device=None):
        return torch.from_numpy(self(shape)).to(dtype=dtype, device=device)


@pytest.mark.parametrize("name", LAYERS)
@pytest.mark.parametrize("calibrated", [True, False])
def test_quantized_layer_matches_jax(monkeypatch, name, calibrated):
    """Each Flipout class and each transposed reparameterization class,
    calibrated (the 10- or 5-slot quant_dict) and default-scale, with
    JAX's frozen draw pinned through the frozen buffers and the signs
    injected: the f32 output and the QTensor output equal JAX's."""
    jl, tl, shape, own = _converted_pair(name, calibrated, seed=3)
    flipout = name.endswith("Flipout")
    assert tl.estimator == jl.estimator
    assert (own is not None) == calibrated
    if calibrated:
        assert len(own) == len(jl.quant_dict) == (10 if flipout else 5)
    assert tl.quant_dict == jl.quant_dict
    x = (np.random.RandomState(4).randn(*shape) * 2).astype(np.float32)
    signs = {}
    if flipout:
        src = _Signs()
        monkeypatch.setattr(jsampling, "rademacher_fused", src.jax)
    jout, jkl = jl(jnp.asarray(x))
    if flipout:
        src.calls = 0
        signs = dict(sign_in=src.torch(0, x.shape),
                     sign_out=src.torch(0, np.asarray(jout).shape))
    tout, tkl = tl(_t(x), **signs)
    _equal(jout, tout)
    assert jkl == 0 and tkl == 0
    assert np.abs(np.asarray(jout)).max() > 0  # a signal
    tl.q_output = jl.q_output = True
    if flipout:
        src.calls = 0
    jqo = jl(jnp.asarray(x), return_kl=False)
    tqo = tl(_t(x), return_kl=False, **signs)
    assert isinstance(tqo, tqt.QTensor) and tqo.q.dtype == torch.uint8
    _equal(jqo.q, tqo.q.contiguous())
    assert (tqo.scale, tqo.zp) == (jqo.scale, jqo.zp)


@pytest.mark.parametrize("name", ["LinearFlipout", "Conv2dFlipout",
                                  "ConvTranspose2dFlipout"])
@pytest.mark.parametrize("calibrated", [True, False])
def test_flipout_delta_build_matches_jax(monkeypatch, name, calibrated):
    """The perturbation build on injected eps (quantize, qmul) and the
    perturbation bias equal JAX's, whose normals the test supplies in
    the same order (eps, then the bias's eps)."""
    jl, tl, _, _ = _converted_pair(name, calibrated, seed=5)
    rs = np.random.RandomState(6)
    eps = rs.randn(*jl.quantized_mu_weight.shape).astype(np.float32)
    eps_b = rs.randn(*jl.quantized_mu_bias.shape).astype(np.float32)
    given = iter([eps, eps_b])
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(next(given)))
    jd, js, jb = jl._sampled_qdelta_flipout(6 / 255)
    td, ts, tb = tl._sampled_qdelta_flipout(6 / 255, eps=_t(eps),
                                            eps_b=_t(eps_b))
    _equal(jd, td)
    _equal(jb, tb)
    assert ts == js


def test_flipout_signs_and_eps_moments():
    """The port's own draws, not injected: the signs are +-1 with mean
    near 0 and differ per call; eps (``torch.randn`` on a generator seeded
    from the layer's) has the moments of N(0, 1); two perturbation draws
    differ, and so do two unfrozen forwards."""
    from bayesian_torch_tpu_torch.ops.sampling import device_generator
    from bayesian_torch_tpu_torch.quantization import (
        unfreeze_quantized_draws)
    _, tl, shape, _ = _converted_pair("Conv2dFlipout", True, seed=7)
    n = 200_000
    from bayesian_torch_tpu_torch.ops.cuda.flipout_signs import signs_plain
    a, b = map(signs_plain, tl._signs((n,), (n,), None, None))
    assert set(torch.unique(a).tolist()) == {-1.0, 1.0}
    for signs in (a, b):
        assert abs(float(signs.mean())) < 5 / n ** 0.5
    assert not torch.equal(a, b)
    assert not torch.equal(a, signs_plain(tl._signs((n,), (n,), None,
                                                    None)[0]))
    eps = torch.randn((n,), generator=device_generator(tl.generator, "cpu"))
    assert abs(float(eps.mean())) < 5 / n ** 0.5
    assert abs(float(eps.var()) - 1) < 0.02
    assert abs(float((eps ** 4).mean()) - 3) < 0.1
    assert not torch.equal(tl._sampled_qdelta_flipout(6 / 255)[0],
                           tl._sampled_qdelta_flipout(6 / 255)[0])
    x = _t(np.random.RandomState(8).randn(*shape).astype(np.float32))
    assert unfreeze_quantized_draws(nn.ModuleDict(dict(l=tl))) == 1
    assert not torch.equal(tl(x)[0], tl(x)[0])


@pytest.mark.parametrize("groups", [1, 2])
def test_transposed_bn_folding_scales_output_channels(groups):
    """``quantize()`` of a transposed kernel (I, O/g, *k) with a BN folded
    in scales each output channel (dim 1 within each group) by
    gamma / sqrt(var + eps): the int8 kernel is that of the folded f32
    kernel, and the bias is rebuilt over the O output channels."""
    from bayesian_torch_tpu_torch import layers as TL
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import batch_norm_folding
    from bayesian_torch_tpu_torch.nn import BatchNorm2d
    g = torch.Generator().manual_seed(21)
    conv = TL.ConvTranspose2dFlipout(4, 6, 3, 2, 1, 1, groups, generator=g,
                                     output_padding=1)
    bn = BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(6, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(6, generator=g))
        bn.running_mean.copy_(torch.randn(6, generator=g))
        bn.running_var.copy_(torch.rand(6, generator=g) + 0.5)
    mu = conv.mu_kernel.detach().clone()
    coef = bn.weight.detach() / torch.sqrt(
        (bn.running_var + bn.eps).double()).float()
    folded = (mu.reshape(groups, 4 // groups, 6 // groups, 3, 3)
              * coef.reshape(groups, 1, -1, 1, 1)).reshape(mu.shape)
    for o in range(6):  # output channel o: group o // (6 / g), column o % .
        gi, j = divmod(o, 6 // groups)
        rows = slice(gi * 4 // groups, (gi + 1) * 4 // groups)
        assert torch.equal(folded[rows, j], mu[rows, j] * coef[o])
    mu_b = conv.mu_bias.detach().clone()
    ql = batch_norm_folding(conv, bn)
    assert torch.equal(ql.quantized_mu_weight,
                       tq.quantize_int8(folded, tq.symmetric_scale(folded)))
    torch.testing.assert_close(
        ql.quantized_mu_bias,
        (mu_b - bn.running_mean) * coef + bn.bias.detach())


# --- the legacy ao classes ---------------------------------------------------

# legacy class: the float layer whose posterior it quantizes
LEGACY = {
    "QuantizedLinearReparameterization": "LinearReparameterization",
    "QuantizedConv2dReparameterization": "Conv2dReparameterization",
    "QuantizedConvTranspose2dReparameterization":
        "ConvTranspose2dReparameterization",
    "QuantizedLinearFlipout": "LinearFlipout",
    "QuantizedConv2dFlipout": "Conv2dFlipout",
    "QuantizedConvTranspose2dFlipout": "ConvTranspose2dFlipout",
}


def test_legacy_ao_surface_matches_jax():
    """``ao.nn.quantized.modules`` exports JAX's 14 legacy classes, each a
    subclass of the canonical class with ``legacy_ao`` pinned."""
    import bayesian_torch_tpu.ao.nn.quantized.modules as jmods
    import bayesian_torch_tpu_torch.ao.nn.quantized.modules as tmods
    import bayesian_torch_tpu_torch.layers as TL
    names = sorted(n for n in dir(jmods) if n.startswith("Quantized"))
    assert len(names) == 14
    assert sorted(n for n in dir(tmods) if n.startswith("Quantized")) == names
    for n in names:
        cls = getattr(tmods, n)
        assert cls.legacy_ao is True and getattr(TL, n).legacy_ao is False
        assert issubclass(cls, getattr(TL, n)) and cls is not getattr(TL, n)


@pytest.mark.parametrize("name", list(LEGACY))
def test_legacy_ao_matches_jax(monkeypatch, name):
    """A legacy class: ``quantize()`` takes the bias through an int8 round
    trip (scale 0.1 where it is all zero), the forward runs at the
    default scale 0.1 and ignores a quant_dict. With sigma taken as |rho|
    in both packages (an exact operation) the quantized state equals
    JAX's bit for bit, and so does the forward on a pinned draw with
    injected signs."""
    import bayesian_torch_tpu.ao.nn.quantized.modules as jmods
    import bayesian_torch_tpu.layers.quantized_base as jqb
    import bayesian_torch_tpu_torch.ao.nn.quantized.modules as tmods
    import bayesian_torch_tpu_torch.layers.quantized_base as tqb
    monkeypatch.setattr(jqb, "sigma_from_rho", jnp.abs)
    monkeypatch.setattr(tqb, "sigma_from_rho", torch.abs)
    src = LEGACY[name]
    jf, tf = _float_pair(src, seed=9)
    args, shape = FLOAT[src]
    kw = dict(output_padding=1) if "Transpose" in name and len(args) < 7 \
        else {}
    jl = getattr(jmods, name)(*args, rngs=nnx.Rngs(9), **kw)
    tl = getattr(tmods, name)(*args, **kw)
    for attr in ("mu_weight", "rho_weight", "mu_kernel", "rho_kernel",
                 "mu_bias", "rho_bias"):
        if getattr(jf, attr, None) is not None:
            setattr(jl, attr, getattr(jf, attr))
            setattr(tl, attr, getattr(tf, attr))
    jl.quantize(), tl.quantize()
    for key, value in tl.state_dict().items():
        _equal(getattr(jl, key)[...], value)
    # the bias went through int8: a multiple of its scale
    scale = tq.symmetric_scale(tf.mu_bias.detach())
    assert torch.equal(tl.quantized_mu_bias,
                       tq.quantize_int8(tf.mu_bias.detach(), scale).float()
                       * scale)
    jl.quant_dict = tl.quant_dict = [{"scale": 9.0, "zero_point": 3.0}] * 10
    from bayesian_torch_tpu.quantization import freeze_quantized_draws as jf_
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state
    jh, th = _JaxHolder(jl), nn.ModuleDict(dict(l=tl))
    jf_(jh)
    arrays, _ = _jax_quant_state(jh)
    load_jax_quant_state(th, arrays)
    x = (np.random.RandomState(10).randn(*shape)).astype(np.float32)
    signs = {}
    if name.endswith("Flipout"):
        s = _Signs()
        monkeypatch.setattr(jsampling, "rademacher_fused", s.jax)
    jout = jl(jnp.asarray(x), return_kl=False)
    if name.endswith("Flipout"):
        s.calls = 0
        signs = dict(sign_in=s.torch(0, x.shape),
                     sign_out=s.torch(0, np.asarray(jout).shape))
    tout = tl(_t(x), return_kl=False, **signs)
    _equal(jout, tout)
    # the default-scale grid of the legacy classes: multiples of 0.1
    q = tout / 0.1
    assert torch.allclose(q, torch.round(q), atol=1e-3)


# --- observers -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["qint8", "quint8"])
def test_per_channel_observer_matches_jax(dtype):
    from bayesian_torch_tpu.quantization import observers as jo
    from bayesian_torch_tpu_torch.quantization import observers as to
    rs = np.random.RandomState(11)
    for axis in (0, 1, -1):
        jo_ = jo.PerChannelMinMaxObserver(dtype, ch_axis=axis)
        to_ = to.PerChannelMinMaxObserver(dtype, ch_axis=axis)
        assert not to_.observed
        for s, o in ((1.0, 0.3), (4.0, -1.0), (0.2, 2.0)):
            x = (rs.randn(3, 5, 4) * s + o).astype(np.float32)
            jo_(jnp.asarray(x))
            assert torch.equal(to_(_t(x)), _t(x))
        assert to_.observed
        (js, jz), (ts, tz) = jo_.calculate_qparams(), to_.calculate_qparams()
        np.testing.assert_array_equal(js, ts)
        np.testing.assert_array_equal(jz, tz)
    never = to.PerChannelMinMaxObserver(dtype).calculate_qparams()
    np.testing.assert_array_equal(
        never[0], jo.PerChannelMinMaxObserver(dtype).calculate_qparams()[0])


@pytest.mark.parametrize("dtype", ["qint8", "quint8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_observer_matches_jax(dtype, seed):
    """qparams within 1e-6 relative of the JAX observer's after each of
    four batches whose range grows (the remap of the old counts onto the
    new edges runs three times), heavy-tailed data; the histograms
    themselves may differ by the f32 rounding of their cumulative sums
    (another summation order)."""
    from bayesian_torch_tpu.quantization import observers as jo
    from bayesian_torch_tpu_torch.quantization import observers as to
    rs = np.random.RandomState(seed)
    jo_, to_ = jo.HistogramObserver(dtype), to.HistogramObserver(dtype)
    assert jo_.calculate_qparams() == to_.calculate_qparams()
    for s, o in ((1.0, 0.5), (3.0, -1.0), (0.5, 2.0), (8.0, 0.0)):
        x = (rs.standard_t(3, 4000) * s + o).astype(np.float32)
        jo_(jnp.asarray(x))
        to_(_t(x))
        (js, jz), (ts, tz) = jo_.calculate_qparams(), to_.calculate_qparams()
        assert abs(ts - js) <= 1e-6 * abs(js) and tz == jz, (js, ts, jz, tz)
        np.testing.assert_allclose(to_.histogram.numpy(),
                                   np.asarray(jo_.histogram[...]),
                                   rtol=1e-5, atol=0.05)
    const = to.HistogramObserver(dtype)
    const(torch.full((10,), 2.0))
    jconst = jo.HistogramObserver(dtype)
    jconst(jnp.full((10,), 2.0))
    assert const.calculate_qparams() == jconst.calculate_qparams()


def test_observers_calibrate_a_layer():
    """``prepare`` with a HistogramObserver QConfig calibrates a layer and
    converts it; the per-tensor harvest takes its qparams."""
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn
    from bayesian_torch_tpu_torch.quantization import (
        HistogramObserver, MinMaxObserver, QConfig, prepare)
    _, tl = _float_pair("Conv2dFlipout", seed=12)
    holder = nn.ModuleDict(dict(l=tl))
    prepare(holder, QConfig(
        activation=HistogramObserver.with_args(dtype="quint8"),
        weight=MinMaxObserver.with_args(dtype="qint8")))
    assert isinstance(tl.quint_quant[0], HistogramObserver)
    with torch.no_grad():
        tl(torch.randn(2, 4, 6, 6))
    want = [ob.calculate_qparams() for ob in tl.quint_quant]
    bnn_to_qbnn(holder)
    got = [(d["scale"], d["zero_point"]) for d in holder["l"].quant_dict]
    assert got[2:] == want


# --- QuantizedBatchNorm2d --------------------------------------------------


def test_quantized_batchnorm_matches_jax():
    """A QTensor in: the requantized uint8 output within one quantum of
    JAX's and equal on at least 99.9 % of elements (the two eval-BN
    formulas may differ in the last ulp, which can move a value across a
    rounding boundary); float in: float out, as the float BN; the
    ``(x, kl)`` convention."""
    from bayesian_torch_tpu.layers import QuantizedBatchNorm2d as JQBN
    from bayesian_torch_tpu.utils.checkpoint import import_torch_state_dict
    from bayesian_torch_tpu_torch.layers import QuantizedBatchNorm2d as TQBN
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import QBatchNorm2d
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
    assert QBatchNorm2d is TQBN
    jbn, tbn = JQBN(16), TQBN(16)
    arrays = tp.random_state(tp.jax_arrays(jbn), seed=13)
    import_torch_state_dict(jbn, arrays)
    tp.set_jax_eval(jbn)
    load_jax_state(tbn, arrays)
    tbn.eval()
    q = np.random.RandomState(14).randint(0, 256, (8, 16, 12, 12)).astype(
        np.uint8)
    jo = jbn(jqt.QTensor(jnp.asarray(q), 0.1, 120))
    to_ = tbn(tqt.QTensor(_t(q), 0.1, 120))
    assert isinstance(to_, tqt.QTensor) and (to_.scale, to_.zp) == (0.1, 128)
    a, b = np.asarray(jo.q).astype(int), to_.q.numpy().astype(int)
    assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.999
    assert 0.01 < ((b == 0) | (b == 255)).mean() < 0.5  # clamps exercised
    x = np.random.RandomState(15).randn(2, 16, 5, 5).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jbn(jnp.asarray(x))),
                               tbn(_t(x)).detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    out, kl = tbn((tqt.QTensor(_t(q), 0.05, 120), 0.0))
    assert isinstance(out, tqt.QTensor) and kl == 0


def test_quantize_batchnorm_conversion_matches_jax():
    """``bnn_to_qbnn(quantize_batchnorm=True)`` on the narrow ResNet: the
    same layers swapped as in JAX, and with JAX's int8 state, quant_dicts
    and frozen draws carried across, the logits within 3 head quanta of
    JAX's and at least 90 % equal (the bounds of
    ``test_prepare_calibrate_convert_matches_jax``: the BN formulas and
    the pool's sums may differ in the last ulp)."""
    from bayesian_torch_tpu.models.bnn_to_qbnn import bnn_to_qbnn as jb2q
    from bayesian_torch_tpu.quantization import (
        freeze_quantized_draws as jfreeze, prepare as jprepare)
    from bayesian_torch_tpu_torch.layers import QuantizedBatchNorm2d
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn
    from bayesian_torch_tpu_torch.quantization import prepare
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state
    jm, tm = _qtiny_twins(seed=16, mu_scale=0.3)
    jprepare(jm), prepare(tm)
    for i in range(2):
        jm(jnp.asarray(_images(70 + i)))
    jb2q(jm, quantize_activations=True, quantize_batchnorm=True)
    bnn_to_qbnn(tm, quantize_activations=True, quantize_batchnorm=True)
    swapped = sorted(n for n, m in tm.named_modules()
                     if isinstance(m, QuantizedBatchNorm2d))
    assert len(swapped) == 8  # bn1 and the blocks' seven
    jfreeze(jm)
    load_jax_quant_state(tm, *_jax_quant_state(jm))
    x = _images(72)
    want = np.asarray(jm(jnp.asarray(x))[0])
    got = tm(_t(x))[0].numpy()
    head_q = tm.fc.quant_dict[4]["scale"]
    diff = np.abs(got - want)
    assert np.abs(want).max() > 0.5
    assert diff.max() <= 3 * head_q * (1 + 1e-6), diff.max() / head_q
    assert (diff == 0).mean() >= 0.9


# --- the narrow Flipout ResNet and the qresnet factories ------------------

CASES = {
    # (calibrated, fuse_conv_bn, quantize_activations, mu_scale)
    "calibrated-fused-uint8": (True, True, True, 1.0),
    "uncalibrated-fused-uint8": (False, True, True, 0.3),
    "calibrated-bn-f32": (True, False, False, 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flipout_prepare_calibrate_convert_matches_jax(monkeypatch, case):
    """The narrow Flipout ResNet through ``prepare`` -> calibrate ->
    ``convert``: the port's own conversion gives JAX's int8 state (as
    ``_assert_quant_state_close`` states), the port's calibration fills
    every layer's 10-slot quant_dict, and with JAX's quant_dicts and
    frozen perturbations carried across and the same signs injected into
    both, the logits agree at the bounds of
    ``test_prepare_calibrate_convert_matches_jax``: within 3 head quanta,
    at least 90 % equal (the pool's f32 sums and, with float BN, the BN
    formulas may differ in the last ulp)."""
    from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh
    from bayesian_torch_tpu.quantization import (
        convert as jconvert, freeze_quantized_draws as jfreeze,
        prepare as jprepare)
    from bayesian_torch_tpu_torch.quantization import convert, prepare
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state
    calibrated, fuse, qa, mu_scale = CASES[case]
    jm, tm = _qtiny_twins(seed=17, mu_scale=mu_scale, estimator=tp.FLIPOUT)
    jprepare(jm), prepare(tm)
    if calibrated:
        for i in range(3):
            jm(jnp.asarray(_images(20 + i)))
            with torch.no_grad():
                tm(_t(_images(20 + i)))
    jconvert(jm, fuse_conv_bn=fuse, quantize_activations=qa)
    convert(tm, fuse_conv_bn=fuse, quantize_activations=qa)
    layers = [m for m in tm.modules() if hasattr(m, "quant_dict")]
    assert len(layers) == 9 and all(m.estimator == "flipout"
                                    for m in layers)
    assert all((m.quant_dict is not None
                and len(m.quant_dict) == 10) == calibrated for m in layers)
    arrays, _ = _jax_quant_state(jm)
    state = tm.state_dict()
    assert set(state) == set(arrays)
    _assert_quant_state_close(state, arrays)
    jfreeze(jm)
    load_jax_quant_state(tm, *_jax_quant_state(jm))
    src = _Signs()
    monkeypatch.setattr(jsampling, "rademacher_fused", src.jax)
    x = _images(30)
    want = np.asarray(jm(jnp.asarray(x))[0])
    jax_calls, src.calls = src.calls, 0
    monkeypatch.setattr(
        kh, "signs_plain", lambda block, dtype=torch.float32, device=None:
        src.torch(None, block.lanes_shape, dtype, device))
    got, kl = tm(_t(x))
    assert src.calls == jax_calls == 18  # two signs a layer
    got = got.numpy()
    assert got.shape == (2, 10) and float(kl) == 0.0
    assert np.abs(want).max() > 0.5
    head_q = tm.fc.quant_dict[9]["scale"] if calibrated else 0.2
    diff = np.abs(got - want)
    assert diff.max() <= 3 * head_q * (1 + 1e-6), diff.max() / head_q
    assert (diff == 0).mean() >= 0.9


def test_flipout_qresnet_factories():
    """``quantized_resnet_flipout_large``: the JAX module's names, and
    ``qresnet18`` (Flipout) calibrated, folded and converted to 21
    quantized Flipout layers whose MC mean is finite; frozen
    perturbations leave the signs per call."""
    import bayesian_torch_tpu.models.bayesian.\
        quantized_resnet_flipout_large as jzoo
    import bayesian_torch_tpu_torch.models.bayesian.\
        quantized_resnet_flipout_large as tzoo
    from bayesian_torch_tpu_torch.parallel import mc_forward
    from bayesian_torch_tpu_torch.quantization import freeze_quantized_draws
    assert tzoo.__all__ == jzoo.__all__

    def calibrate(model):
        with torch.no_grad():
            model(torch.randn(2, 3, 32, 32,
                              generator=torch.Generator().manual_seed(1)))

    m = tzoo.qresnet18(num_classes=10,
                       generator=torch.Generator().manual_seed(0),
                       calibrate=calibrate, fuse_conv_bn=True)
    layers = [l for l in m.modules() if hasattr(l, "quant_dict")]
    assert len(layers) == 21
    assert all(l.estimator == "flipout" and len(l.quant_dict) == 10
               for l in layers)
    assert isinstance(m.bn1, nn.Identity)
    assert m.layer1[0].conv1.q_output is True
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    mean = mc_forward(m, x, 2, reduce="mean", return_kl=False)
    assert mean.shape == (2, 10) and torch.isfinite(mean).all()
    assert freeze_quantized_draws(m) == 21
    assert not torch.equal(m(x)[0], m(x)[0])  # the signs stay per call


# --- the quantized presample ----------------------------------------------


def test_quantized_presample_equals_in_body_builds():
    """``_presample_layers`` builds each INT8 reparameterization layer's S
    int8 weights in one pass: equal to S in-body builds on the same eps;
    the draw loop reads draw s (a forward on draw s pinned as a frozen
    draw gives the loop's output s); on the default path a call at
    another normal_scale than the record's is refused."""
    from bayesian_torch_tpu_torch.ops.sampling import device_generator
    from bayesian_torch_tpu_torch.parallel import mc_forward
    from bayesian_torch_tpu_torch.parallel.mc import _presample_layers
    from bayesian_torch_tpu_torch.quantization import convert, prepare
    for calibrated in (True, False):
        _, tm = _qtiny_twins(seed=18, mu_scale=0.3)
        prepare(tm)
        if calibrated:
            with torch.no_grad():
                tm(_t(_images(40)))
        convert(tm, fuse_conv_bn=True, quantize_activations=True)
        layers = [m for m in tm.modules() if hasattr(m, "quant_dict")]
        states = [m.generator.get_state() for m in layers]
        S = 3
        records = dict(_presample_layers(tm, S))
        assert list(records) == layers
        for layer, state in zip(layers, states):  # generators may be shared
            layer.generator.set_state(state)
        for layer in layers:
            gen = device_generator(layer.generator, "cpu")
            eps = torch.randn((S,) + tuple(layer.quantized_mu_weight.shape),
                              generator=gen)
            eps_b = None
            if layer.quantized_sigma_bias is not None:
                eps_b = torch.randn(
                    (S,) + tuple(layer.quantized_mu_bias.shape),
                    generator=gen)
            rec = records[layer]
            for s in range(S):
                w, scale, b = layer._sampled_qweight_reparam(
                    6 / 255, eps=eps[s],
                    eps_b=None if eps_b is None else eps_b[s])
                assert torch.equal(rec["_presampled_qw"][s], w)
                assert rec["_presampled_qscale"][s] == scale
                assert rec["_presampled_qnscale"][s] == 6 / 255
                if eps_b is not None:
                    assert torch.equal(rec["_presampled_qbias"][s], b)
                else:
                    assert "_presampled_qbias" not in rec
        x = _t(_images(41))
        for layer, state in zip(layers, states):
            layer.generator.set_state(state)
        outs = mc_forward(tm, x, S, return_kl=False)
        for s in range(S):
            for layer in layers:
                for name, v in records[layer].items():
                    setattr(layer, name, v[s])
            with torch.no_grad():
                assert torch.equal(tm(x)[0], outs[s])
        # layer1[0].conv1 holds draw S - 1 now
        conv = layers[1]
        qx = tqt.QTensor(torch.randint(0, 256, (2, 16, 8, 8),
                                       dtype=torch.uint8), 0.05, 128)
        pres = conv(qx, return_kl=False)
        assert torch.equal(pres.q, conv(qx, return_kl=False).q)
        # the calibrated path reads no normal_scale; the default path
        # refuses one that differs from the record's
        if calibrated:
            other = conv(qx, return_kl=False, normal_scale=5 / 255)
            assert torch.equal(pres.q, other.q)
        else:
            with pytest.raises(ValueError, match="normal_scale"):
                conv(qx, return_kl=False, normal_scale=5 / 255)
