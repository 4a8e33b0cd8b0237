"""The Flipout signs of the port (K-H, ``ops/cuda/flipout_signs.py``) on
the CPU, against the JAX package.

On the CPU the K-H wrappers take their plain versions: the counter hash
in torch, then the product. Their signs equal JAX ``rademacher_fused``'s
bit for bit on the salts of the same keys in every form the port lays
them out in: one tensor, lanes at an NCHW, NHWC or linear axis, an input
shared across the lanes or one a lane, a ``DrawWindow``'s rows, a
tensor-parallel shard's output channels and the LSTM's blocks. The
autograd Functions give torch autograd's gradients through the plain
expressions exactly. Whole ops (Flipout linear, conv in NCHW and NHWC, the
draw axis lane by lane) equal JAX's with eps injected and JAX drawing its
signs, at 1e-5; K-H3 (the INT8 sign product) equals JAX's quantize, qmul
route bit for bit. Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_torch_tpu.ops import conv as jconv
from bayesian_torch_tpu.ops import int8 as jq
from bayesian_torch_tpu.ops import linear as jlinear
from bayesian_torch_tpu.ops import sampling as js
from bayesian_torch_tpu_torch.ops import conv as tconv
from bayesian_torch_tpu_torch.ops import linear as tlinear
from bayesian_torch_tpu_torch.ops import sampling as ts
from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh

TOL = dict(rtol=1e-5, atol=1e-5)
S = 3


def _keys(seed, n=S):
    return list(jax.random.split(jax.random.key(seed), n))


def _salt(key):
    return int(js._key_salt(key))


def _jsigns(key, shape):
    return np.asarray(js.rademacher_fused(key, tuple(shape)))


def _lanes(keys, shape, axis):
    return np.stack([_jsigns(k, shape) for k in keys], axis=axis)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(
        np.asarray(a, dtype=np.float32)).to(dtype)


def _j(a):
    return None if a is None else jnp.asarray(a)


# --- the signs: every layout against JAX, bit for bit ------------------------


@pytest.mark.parametrize("shape", [(4, 999), (2, 3, 5, 7), (5,), (1, 1, 9)])
def test_single_signs_equal_jax(shape):
    key = _keys(1, 1)[0]
    want = _jsigns(key, shape)
    block = ts.sign_block([_salt(key)], shape)
    np.testing.assert_array_equal(kh.sign_flip(None, block).numpy(), want)
    np.testing.assert_array_equal(
        ts.rademacher_fused(_salt(key), shape).numpy(), want)
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(kh.sign_flip(_t(x), block).numpy(),
                                  x * want)


# (per-lane shape, lane axis): NCHW, NHWC (lanes before the channels),
# linear (lanes before the features), a 3-d NCDHW activation
LAYOUTS = [((2, 3, 4, 5), 1), ((2, 4, 5, 3), 3), ((2, 3, 6), 2),
           ((2, 2, 3, 4, 4), 1)]


@pytest.mark.parametrize("shape,axis", LAYOUTS)
@pytest.mark.parametrize("shared", [False, True])
def test_lanes_and_flips_equal_jax(shape, axis, shared):
    """Lane s of the laid-out signs is JAX's signs of draw s's key; the
    flip of an input one a lane or shared across the lanes is the input
    times them, bit for bit."""
    keys = _keys(2)
    want = _lanes(keys, shape, axis)
    salts = [_salt(k) for k in keys]
    block = ts.sign_block(salts, shape, axis=axis)
    assert block.lanes_shape == want.shape
    np.testing.assert_array_equal(
        ts.rademacher_lanes(salts, shape, axis=axis).numpy(), want)
    xshape = list(want.shape)
    if shared:
        xshape[axis] = 1
    x = np.random.RandomState(1).randn(*xshape).astype(np.float32)
    got = kh.sign_flip(_t(x), block)
    np.testing.assert_array_equal(got.numpy(), x * want)
    bf = kh.sign_flip(_t(x, torch.bfloat16), block)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, _t(x, torch.bfloat16) * _t(want, torch.bfloat16))


def test_a_windows_rows_take_their_counters_in_the_whole_batch():
    """Under a ``DrawWindow`` that splits the batch, rows [2, 6) of 8 take
    the whole batch's signs, one tensor and lanes."""
    keys = _keys(3)
    whole = (8, 3, 4, 4)
    window = ts.DrawWindow(0, S, S, 2, 4, 8)
    with ts.draw_window(window):
        one = ts.rademacher_fused(_salt(keys[0]), (4, 3, 4, 4))
        lanes = kh.sign_flip(None, ts.sign_block(
            [_salt(k) for k in keys], (4, 3, 4, 4), axis=1))
        with pytest.raises(RuntimeError, match="batch-leading"):
            ts.sign_block([1], (3, 4, 4, 4))
    np.testing.assert_array_equal(one.numpy(), _jsigns(keys[0], whole)[2:6])
    np.testing.assert_array_equal(lanes.numpy(),
                                  _lanes(keys, whole, 1)[2:6])


@pytest.mark.parametrize("dim", [1, -1])
def test_a_shards_output_signs_are_the_whole_outputs_channels(dim):
    """Inside ``tp_shard(1, 2, dim)`` an output's signs are channels
    [C, 2C) of the whole output's: NCHW (dim 1) and channels-last (-1)."""
    key = _keys(4, 1)[0]
    shape = (2, 3, 4, 4) if dim == 1 else (2, 4, 4, 3)
    whole = list(shape)
    whole[dim] *= 2
    with ts.tp_shard(1, 2, dim):
        got = ts.rademacher_fused(_salt(key), shape, output=True)
        unsharded = ts.rademacher_fused(_salt(key), shape)
    want = np.take(_jsigns(key, whole), np.arange(3, 6), axis=dim)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unsharded.numpy(), _jsigns(key, shape))


def test_lstm_block_is_the_slice_of_the_whole_block():
    """``rademacher_block`` (the LSTM's signs under a mesh window): draws
    [2, 4) and rows [3, 6) of the whole (draws, T, B, features) signs."""
    key = _keys(5, 1)[0]
    whole, start, shape = (5, 4, 6, 8), (2, 0, 3, 0), (2, 4, 3, 8)
    got = ts.rademacher_block(_salt(key), whole, start, shape)
    np.testing.assert_array_equal(got.numpy(),
                                  _jsigns(key, whole)[2:4, :, 3:6, :])
    block = ts.SignBlock((_salt(key),), shape, whole, start)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(kh.sign_flip(_t(x), block).numpy(),
                                  x * got.numpy())


# --- the autograd Functions against torch's autograd -------------------------


def _grads(fn, *tensors):
    ins = [t.clone().requires_grad_(True) for t in tensors]
    out = fn(*ins)
    g = torch.from_numpy(np.random.RandomState(3).randn(*out.shape)).to(
        out.dtype)
    return [out] + list(torch.autograd.grad(out, ins, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
def test_flip_and_combine_gradients_equal_torch_autograd(dtype, shared):
    salts = [ts.sign_salts(9, s)[0] for s in range(S)]
    block = ts.sign_block(salts, (2, 4, 5), axis=1)
    full = block.lanes_shape
    rs = np.random.RandomState(4)
    part = (2, 1, 4, 5) if shared else full
    x = _t(rs.randn(*part), dtype)
    mean, pert = _t(rs.randn(*part), dtype), _t(rs.randn(*full), dtype)
    sign = kh.signs_plain(block, dtype)
    got = _grads(lambda v: kh.sign_flip(v, block), x)
    want = _grads(lambda v: v * sign, x)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    got = _grads(lambda m, p: kh.sign_combine(m, p, block), mean, pert)
    want = _grads(lambda m, p: m + p * sign, mean, pert)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def test_wrappers_refuse_what_does_not_lay_out_the_signs():
    block = ts.sign_block([1, 2], (2, 3), axis=1)
    with pytest.raises(ValueError, match="lay out"):
        kh.sign_flip(torch.ones(2, 3), block)
    with pytest.raises(ValueError, match="lane axis"):
        ts.sign_block([1, 2], (2, 3))
    with pytest.raises(ValueError, match="uint8"):
        kh.qsign_mul(torch.ones(2, 2, 3), 0.1, 0, block, 0.1, 128, 0.1, 128)
    # size 1 is sharing on the lane dim alone: backward sums only there
    for part in ((1, 2, 3), (2, 2, 1)):
        with pytest.raises(ValueError, match="lay out"):
            kh.sign_flip(torch.ones(part), block)
        with pytest.raises(ValueError, match="lay out"):
            kh.sign_combine(torch.ones(part), torch.ones(2, 2, 3), block)
    with pytest.raises(ValueError, match="lay out"):
        kh.sign_flip(torch.ones(1, 3), ts.sign_block([1], (2, 3)))


@pytest.mark.parametrize("shared", [False, True])
def test_second_derivatives_equal_torch_autograd(shared):
    """The backwards are K-H1 as a Function again, so a derivative of a
    gradient (create_graph) equals torch's through the plain expression."""
    salts = [ts.sign_salts(10, s)[0] for s in range(S)]
    block = ts.sign_block(salts, (2, 4, 5), axis=1)
    full = block.lanes_shape
    rs = np.random.RandomState(17)
    x = _t(rs.randn(*((2, 1, 4, 5) if shared else full)))
    w = _t(rs.randn(*full))
    sign = kh.signs_plain(block)

    def second(flip, combine):
        v = x.clone().requires_grad_(True)
        loss = ((flip(v) * v).sum() + (combine(v, v * 2) * w * v).sum())
        g, = torch.autograd.grad(loss, v, create_graph=True)
        return [g] + list(torch.autograd.grad((g * g).sum(), v))

    got = second(lambda v: kh.sign_flip(v, block),
                 lambda m, p: kh.sign_combine(m, p, block))
    want = second(lambda v: v * sign, lambda m, p: m + p * sign)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_sign_uint8_equals_quantize_uint8():
    """K-H3's two uint8 values of +-1, worked out on the host, equal
    ``ops/int8.py``'s ``quantize_uint8`` of [1, -1] over scales from 1e-4
    to 20 and zero points inside and outside [0, 255], whole and not."""
    from bayesian_torch_tpu_torch.ops import int8 as tq

    rs = np.random.RandomState(16)
    scales = np.concatenate([np.exp(rs.uniform(-9.2, 3, 400)),
                             1.0 / np.arange(1, 300), 2.0 / np.arange(1, 300),
                             [6 / 255, 0.1, 0.2, 1.0, 2.0]])
    zps = np.concatenate([np.arange(-3, 259, 7), rs.uniform(-20, 280, 20),
                          [0.0, 127.5, 128.0, 255.0]])
    for scale in scales.tolist():
        for zp in zps[rs.randint(0, len(zps), 8)].tolist():
            want = tq.quantize_uint8(torch.tensor([1.0, -1.0]), scale, zp)
            assert kh.sign_uint8(scale, zp) == tuple(want.tolist()), (scale,
                                                                      zp)


# --- whole ops against JAX, JAX drawing its own signs ------------------------


def _linear_case(rs, lead, n_in=7, n_out=5):
    return dict(
        x=rs.randn(*lead, n_in).astype(np.float32),
        mu=rs.normal(0, 0.3, (n_out, n_in)).astype(np.float32),
        rho=rs.normal(-2, 0.5, (n_out, n_in)).astype(np.float32),
        mu_b=rs.normal(0, 0.3, n_out).astype(np.float32),
        rho_b=rs.normal(-2, 0.5, n_out).astype(np.float32),
        eps=rs.randn(n_out, n_in).astype(np.float32),
        eps_b=rs.randn(n_out).astype(np.float32))


def _deltas(c):
    return (ts.sigma_from_rho(_t(c["rho"])) * _t(c["eps"]),
            ts.sigma_from_rho(_t(c["rho_b"])) * _t(c["eps_b"]))


def _sign_salts(key):
    """The salts of the sign keys JAX's single Flipout ops split off."""
    _, _, k_sin, k_sout = jax.random.split(key, 4)
    return _salt(k_sin), _salt(k_sout)


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_flipout_linear_equals_jax_on_its_sign_keys(lead):
    c = _linear_case(np.random.RandomState(5), lead)
    key = _keys(6, 1)[0]
    want = jlinear.flipout_linear(
        _j(c["x"]), key, _j(c["mu"]), _j(c["rho"]), _j(c["mu_b"]),
        _j(c["rho_b"]), eps_w=_j(c["eps"]), eps_b=_j(c["eps_b"]))
    got = tlinear.flipout_linear_presampled(
        _t(c["x"]), _t(c["mu"]), _t(c["mu_b"]), *_deltas(c),
        _sign_salts(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _conv_case(rs, x_shape, cin, cout=5):
    return dict(
        x=rs.randn(*x_shape).astype(np.float32),
        mu=rs.normal(0, 0.3, (cout, cin, 3, 3)).astype(np.float32),
        rho=rs.normal(-2, 0.5, (cout, cin, 3, 3)).astype(np.float32),
        mu_b=rs.normal(0, 0.3, cout).astype(np.float32),
        rho_b=rs.normal(-2, 0.5, cout).astype(np.float32),
        eps=rs.randn(cout, cin, 3, 3).astype(np.float32),
        eps_b=rs.randn(cout).astype(np.float32))


def _jax_conv(c, key, data_format, x=None, eps=None, eps_b=None):
    return np.asarray(jconv.flipout_conv(
        _j(c["x"] if x is None else x), key, _j(c["mu"]), _j(c["rho"]),
        _j(c["mu_b"]), _j(c["rho_b"]), padding=1,
        eps_k=_j(c["eps"] if eps is None else eps),
        eps_b=_j(c["eps_b"] if eps_b is None else eps_b),
        data_format=data_format))


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["two", "fused"])
def test_flipout_conv_equals_jax_on_its_sign_keys(data_format, mode):
    shape = (2, 4, 6, 6) if data_format == "NCHW" else (2, 6, 6, 4)
    c = _conv_case(np.random.RandomState(7), shape, 4)
    key = _keys(8, 1)[0]
    want = _jax_conv(c, key, data_format)
    delta, pert_b = _deltas(c)
    salts = _sign_salts(key)
    got = tconv._flipout_apply(
        _t(c["x"]), _t(c["mu"]), _t(c["mu_b"]), delta, pert_b, salts, None,
        None, mode, False, dict(stride=1, padding=1, output_padding=0,
                                dilation=1, groups=1, compute_dtype=None,
                                data_format=data_format))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("shared", [False, True])
def test_flipout_conv_draws_lane_s_equals_jax_on_draw_s_keys(data_format,
                                                             shared):
    """The draw axis (K-H1 over the lanes, K-H2 on the lanes' outputs):
    lane s equals JAX's single ``flipout_conv`` under draw s's key, its
    signs drawn by JAX."""
    rs = np.random.RandomState(9 + shared)
    C, O, B, H = 4, 5, 2, 6
    last = data_format == "NHWC"
    width = C if shared else S * C
    shape = (B, H, H, width) if last else (B, width, H, H)
    c = _conv_case(rs, shape, C, O)
    eps = rs.randn(S, O, C, 3, 3).astype(np.float32)
    eps_b = rs.randn(S, O).astype(np.float32)
    keys = _keys(10)
    sig = ts.sigma_from_rho(_t(c["rho"]))
    sig_b = ts.sigma_from_rho(_t(c["rho_b"]))
    got = tconv.flipout_conv_draws(
        _t(c["x"]), _t(c["mu"]), _t(c["mu_b"]), sig * _t(eps),
        sig_b * _t(eps_b), [_sign_salts(k) for k in keys], padding=1,
        data_format=data_format).numpy()
    for s, key in enumerate(keys):
        if shared:
            xs = c["x"]
        elif last:
            xs = c["x"][..., s * C:(s + 1) * C]
        else:
            xs = c["x"][:, s * C:(s + 1) * C]
        want = _jax_conv(c, key, data_format, x=xs, eps=eps[s],
                         eps_b=eps_b[s])
        lane = got[..., s * O:(s + 1) * O] if last \
            else got[:, s * O:(s + 1) * O]
        np.testing.assert_allclose(lane, want, **TOL)


@pytest.mark.parametrize("shared", [False, True])
def test_flipout_linear_draws_lane_s_equals_jax_on_draw_s_keys(shared):
    rs = np.random.RandomState(11 + shared)
    K, N = 7, 5
    c = _linear_case(rs, (4,), K, N)
    x = c["x"] if shared else rs.randn(4, S * K).astype(np.float32)
    eps = rs.randn(S, N, K).astype(np.float32)
    eps_b = rs.randn(S, N).astype(np.float32)
    keys = _keys(12)
    got = tlinear.flipout_linear_draws(
        _t(x), _t(c["mu"]), _t(c["mu_b"]),
        ts.sigma_from_rho(_t(c["rho"])) * _t(eps),
        ts.sigma_from_rho(_t(c["rho_b"])) * _t(eps_b),
        [_sign_salts(k) for k in keys]).numpy()
    for s, key in enumerate(keys):
        xs = x if shared else x[:, s * K:(s + 1) * K]
        want = jlinear.flipout_linear(
            _j(xs), key, _j(c["mu"]), _j(c["rho"]), _j(c["mu_b"]),
            _j(c["rho_b"]), eps_w=_j(eps[s]), eps_b=_j(eps_b[s]))
        np.testing.assert_allclose(got[:, s * N:(s + 1) * N],
                                   np.asarray(want), **TOL)


# --- K-H3: the INT8 sign product ---------------------------------------------

# (a scale, a zero point, sign scale, sign zero point, out scale, out zp):
# a calibrated layer's, and the uncalibrated default (0.2, 128 throughout)
QSCALES = [(0.031, 117.0, 0.0079, 127.0, 0.045, 121.0),
           (0.2, 128.0, 0.2, 128.0, 0.2, 128.0)]


@pytest.mark.parametrize("scales", QSCALES)
@pytest.mark.parametrize("shape,axis", [((2, 3, 4, 5), None),
                                        ((2, 3, 4, 5), 1),
                                        ((2, 4, 5, 3), 3)])
def test_qsign_mul_equals_jax_quantize_and_qmul(scales, shape, axis):
    """``qmul(a, quantize_uint8(signs))`` as the JAX quantized Flipout
    layer computes it, bit for bit, one tensor and lanes."""
    sa, za, ss, zs, so, zo = scales
    keys = _keys(13, 1 if axis is None else S)
    if axis is None:
        signs = _jsigns(keys[0], shape)
    else:
        signs = _lanes(keys, shape, axis)
    block = ts.sign_block([_salt(k) for k in keys], shape, axis=axis)
    a = np.random.RandomState(14).randint(0, 256, signs.shape).astype(
        np.uint8)
    want = np.asarray(jq.qmul(
        jnp.asarray(a), sa, jq.quantize_uint8(jnp.asarray(signs), ss, zs),
        ss, so, zo, a_zp=za, b_zp=zs, out_dtype=jnp.uint8))
    got = kh.qsign_mul(torch.from_numpy(a), sa, za, block, ss, zs, so, zo)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 8
    assert kh.sign_uint8(ss, zs) == tuple(
        np.asarray(jq.quantize_uint8(jnp.asarray([1.0, -1.0]), ss,
                                     zs)).tolist())


def test_quantized_flipout_sign_product_is_the_tensor_route():
    """The quantized layer's two sign products: on a ``SignBlock`` (the
    card's route, K-H3's plain version here) equal to the sign tensor's
    route, one forward and over the draw axis."""
    from bayesian_torch_tpu_torch.layers.quantized_base import (
        _QuantizedLayerBase,
    )

    rs = np.random.RandomState(15)
    mul = _QuantizedLayerBase._sign_mul
    for shape, axis in (((2, 6), None), ((2, 3, 4), 1),
                        ((2, 4, 4, 3), 3)):
        salts = [ts.sign_salts(21, s)[1] for s in range(
            1 if axis is None else S)]
        block = ts.sign_block(salts, shape, axis=axis)
        full = block.lanes_shape
        flat = list(shape)  # the layer's (B, S*C, ...): lanes merged
        if axis is not None:
            flat[axis] *= S
        a = torch.from_numpy(rs.randint(0, 256, full).astype(np.uint8))
        sign = kh.signs_plain(block)
        args = (0.05, 120.0)
        tail = (0.0078, 128.0, 0.04, 126.0)
        got = mul(a.reshape(flat), *args, block, *tail)
        want = mul(a.reshape(flat), *args, sign.reshape(flat), *tail)
        assert got.shape == tuple(flat) and torch.equal(got, want)


# --- the launch counts chip_smoke.py gates its Flipout paths by --------------


def _count_signs(monkeypatch):
    """Count the K-H wrappers' plain versions as their launches."""
    counted = {"K-H1": 0, "K-H2": 0}
    real_flip = kh.sign_flip

    def plain(name, fn):
        def counted_fn(*args, **kw):
            counted[name] += 1
            return fn(*args, **kw)
        return counted_fn

    def flip(x, *args, **kw):
        if x is None:
            counted["K-H1"] += 1
        return real_flip(x, *args, **kw)

    monkeypatch.setattr(kh, "sign_flip_plain",
                        plain("K-H1", kh.sign_flip_plain))
    monkeypatch.setattr(kh, "sign_combine_plain",
                        plain("K-H2", kh.sign_combine_plain))
    monkeypatch.setattr(kh, "sign_flip", flip)
    return counted


@pytest.mark.parametrize("vmap", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_chip_smoke_sign_launch_counts_match_a_call(monkeypatch, vmap,
                                                    training):
    """``chip_smoke.expected_sign_launches`` against the K-H calls of the
    narrow Flipout ResNet's MC-2 forward and ELBO step, through the loop
    and the draw axis."""
    import chip_smoke as cs
    from bayesian_torch_tpu_torch.examples import _engine as engine
    from bayesian_torch_tpu_torch.parallel import mc as tmc
    from tests._torch_port import FLIPOUT, TorchTiny

    counted = _count_signs(monkeypatch)
    tm = TorchTiny(torch.Generator().manual_seed(3), FLIPOUT)
    x = _t(np.random.RandomState(16).randn(2, 3, 16, 16))
    emission = "vmap" if vmap else "scan"
    if training:
        opt = torch.optim.SGD(tm.parameters(), lr=0.01)
        engine.make_train_step(2, 2, emission=emission)(
            tm.train(), opt, x, torch.tensor([1, 4]))
    else:
        tmc.mc_forward(tm.eval(), x, 2, return_kl=False, emission=emission)
    want = cs.expected_sign_launches(tm, 2, vmap=vmap, training=training)
    assert counted == {k: want[k] for k in counted}
    assert want["K-H1"] > 0 and want["K-H3"] == 0


@pytest.mark.parametrize("vmap", [False, True])
def test_chip_smoke_sign_launch_counts_of_the_lstm(monkeypatch, vmap):
    """The Flipout LSTM regressor (phase 41's model at hidden 4): its four
    sign blocks a forward through K-H1, its Flipout head's flip and
    combine."""
    import chip_smoke as cs
    from bayesian_torch_tpu_torch.examples.main_bayesian_lstm_timeseries \
        import BayesianLSTMRegressor
    from bayesian_torch_tpu_torch.parallel import mc as tmc

    counted = _count_signs(monkeypatch)
    tm = BayesianLSTMRegressor(4, "Flipout",
                               generator=torch.Generator().manual_seed(5))
    x = _t(np.random.RandomState(17).randn(3, 6, 1))
    with torch.no_grad():
        tmc.mc_forward(tm.eval(), x, 3, return_kl=False,
                       emission="vmap" if vmap else "scan")
    want = cs.expected_sign_launches(tm, 3, vmap=vmap)
    assert counted == {k: want[k] for k in counted}
    assert want["K-H1"] == (1 if vmap else 3) * 5
