"""CPU parity of INT8 Flipout's fused sign products with the JAX package:
K-F's Flipout epilogue (``ops/cuda/qmatmul.py::qmatmul_requant_flipout``:
the perturbation's product, its output sign product and the add to the
mean) and K-H3's input pass (``ops/cuda/flipout_signs.py::qsign_mul`` with
``requant``: a ``QTensor``'s requantize and its sign product in one read),
through their plain versions on CPU tensors. Inputs are numpy arrays from
fixed seeds.

- (a) the epilogue's plain version (through ``ops.int8.qlinear`` /
  ``qconv`` with ``flipout=``) against the JAX chain ``qlinear`` /
  ``qconv`` -> ``rademacher_fused`` -> ``quantize_uint8`` -> ``qmul`` ->
  ``qadd`` of ``bayesian_torch_tpu/layers/quantized_base.py``'s Flipout
  forward, bit for bit: linear, conv NCHW and NHWC, grouped, transposed,
  lanes on the draw axis, calibrated and default scales, and scales where
  the clamps bite;
- (b) the affine counter map (``SignMap``) each GEMM hands the kernel
  against the counters of ``_lane_counters`` and the signs of
  ``signs_plain`` of the same ``SignBlock``, at every element;
- (c) the input pass's plain version against JAX's ``QTensor.requantize``
  and ``qmul`` of the quantized signs, with and without a requantize;
- (d) a quantized Flipout layer on its ``SignBlock`` route: no ``int8.qadd``
  of its own and one ``qmatmul_requant_flipout`` a perturbation GEMM, its
  output equal to the injected-tensor route's.

Every int8 result is compared for equality: both packages run the same
integer and f32 operations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from bayesian_torch_tpu.ops import int8 as jq
from bayesian_torch_tpu.ops import qtensor as jqt
from bayesian_torch_tpu.ops import sampling as js
from bayesian_torch_tpu_torch.ops import int8 as tq
from bayesian_torch_tpu_torch.ops import sampling as ts
from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh
from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf
from bayesian_torch_tpu_torch.ops.qtensor import QTensor

torch.set_num_threads(1)


def _salt(key):
    return int(js._key_salt(key))


def _equal(want, got):
    got = got.contiguous().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(want), got)


# --- (a) the epilogue's plain version against the JAX chain ----------------

# (w_mu and s1 the mean's and the perturbation's weight scales, s3/z3 the
# mean's, s5/z5 the output signs', s6/z6 the signed input's, s7/z7 the
# perturbation product's, s8/z8 the signed product's, s9/z9 the sum's)
SCALES = {
    "calibrated": dict(w_mu=0.0097, s1=0.0123, s3=0.25, z3=121.0, s5=0.0079,
                       z5=127.0, s6=0.031, z6=117.0, s7=0.3, z7=119.0,
                       s8=0.29, z8=124.0, s9=0.41, z9=126.0),
    "default": dict(w_mu=0.0003, s1=0.0004, s3=0.2, z3=128.0, s5=0.2,
                    z5=128.0, s6=0.2, z6=128.0, s7=0.2, z7=128.0, s8=0.2,
                    z8=128.0, s9=0.2, z9=128.0),
    # small product and sum scales: most of p, p2 and the sum clamp
    "clamped": dict(w_mu=0.0097, s1=0.0123, s3=0.043, z3=121.0, s5=0.0079,
                    z5=127.0, s6=0.031, z6=117.0, s7=0.004, z7=119.0,
                    s8=0.003, z8=124.0, s9=0.006, z9=126.0),
}

# conv geometries: (x shape NCHW, kernel shape, qconv keywords)
GEOMS = {
    "conv": ((2, 6, 7, 7), (8, 6, 3, 3), dict(padding=1)),
    "conv-nhwc": ((2, 6, 7, 7), (8, 6, 3, 3),
                  dict(padding=1, data_format="NHWC")),
    "grouped": ((2, 6, 7, 7), (8, 3, 3, 3), dict(padding=1, groups=2)),
    "grouped-nhwc-stride2": ((2, 8, 9, 9), (8, 2, 3, 3),
                             dict(stride=2, padding=1, groups=4,
                                  data_format="NHWC")),
    "transposed": ((2, 6, 5, 5), (6, 4, 4, 4),
                   dict(stride=2, padding=1, transposed=True)),
    "transposed-grouped": ((2, 6, 5, 5), (6, 2, 3, 3),
                           dict(stride=2, groups=3, output_padding=1,
                                transposed=True)),
}


def _conv_operands(rs, geom, lanes=1):
    """uint8 x_tmp, int8 mean and perturbation kernels, f32 biases; a
    leading lane axis on the kernels and biases."""
    x_shape, w_shape, kw = GEOMS[geom]
    g = kw.get("groups", 1)
    o = w_shape[1] * g if kw.get("transposed") else w_shape[0]
    x = rs.randint(0, 256, (x_shape[0], lanes * x_shape[1]) + x_shape[2:])
    mu = rs.randint(-128, 128, (lanes,) + w_shape)
    delta = rs.randint(-128, 128, (lanes,) + w_shape)
    return (x.astype(np.uint8), mu.astype(np.int8), delta.astype(np.int8),
            rs.randn(lanes, o).astype(np.float32),
            rs.randn(lanes, o).astype(np.float32), dict(kw))


def _last(a, nhwc):
    """NCHW numpy -> the layout of ``nhwc``."""
    return np.moveaxis(a, 1, -1) if nhwc else a


def _jax_flipout(mean, pert, key, sc):
    """JAX's chain after the perturbation product (quantized_base.py's
    Flipout forward): the output signs, their quantize, qmul, qadd."""
    sign = js.rademacher_fused(key, pert.shape, jnp.float32)
    sign_q = jq.quantize_uint8(sign, sc["s5"], sc["z5"])
    p2 = jq.qmul(pert, sc["s7"], sign_q, sc["s5"], sc["s8"], sc["z8"],
                 a_zp=sc["z7"], b_zp=sc["z5"], out_dtype=jnp.uint8)
    return jq.qadd(mean, sc["s3"], p2, sc["s8"], sc["s9"], sc["z9"],
                   a_zp=sc["z3"], b_zp=sc["z8"], out_dtype=jnp.uint8)


def _epilogue(mean, block, channel_dim, sc):
    return tq.FlipoutEpilogue(mean, sc["s3"], sc["z3"],
                              kh.OutputSigns(block, channel_dim), sc["s5"],
                              sc["z5"], sc["s8"], sc["z8"], sc["s9"],
                              sc["z9"])


@pytest.mark.parametrize("scales", list(SCALES))
@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("lanes", [1, 3])
def test_conv_epilogue_equals_the_jax_chain(geom, scales, lanes):
    """The perturbation conv with K-F's Flipout epilogue (plain version)
    equals JAX's qconv -> signs -> quantize -> qmul -> qadd, one forward
    (one salt) and a draw-axis call (lane s: its block of the channels,
    its kernel and bias, its own signs, one GEMM a lane and group)."""
    sc = SCALES[scales]
    rs = np.random.RandomState(len(geom) * 31 + lanes)
    x, mu, delta, b_mu, b_d, kw = _conv_operands(rs, geom, lanes)
    nhwc = kw.get("data_format") == "NHWC"
    keys = list(jax.random.split(jax.random.key(len(scales) + lanes), lanes))
    C = x.shape[1] // lanes
    wants, means = [], []
    for s in range(lanes):
        xs = jnp.asarray(_last(x[:, s * C:(s + 1) * C], nhwc))
        mean = jq.qconv(xs, sc["s6"], sc["z6"], jnp.asarray(mu[s]),
                        sc["w_mu"],
                        jnp.asarray(b_mu[s]), sc["s3"], sc["z3"], **kw)
        pert = jq.qconv(xs, sc["s6"], sc["z6"], jnp.asarray(delta[s]),
                        sc["s1"], jnp.asarray(b_d[s]), sc["s7"], sc["z7"],
                        **kw)
        wants.append(np.asarray(_jax_flipout(mean, pert, keys[s], sc)))
        means.append(np.asarray(mean))
    cdim = -1 if nhwc else 1
    want = np.concatenate(wants, axis=cdim)
    mean = torch.from_numpy(np.concatenate(means, axis=cdim))
    salts = [_salt(k) for k in keys]
    one = list(want.shape)
    one[cdim] //= lanes
    block = ts.sign_block(salts, one, axis=cdim % len(one)) if lanes > 1 \
        else ts.sign_block(salts, one)
    w = torch.from_numpy(delta.reshape((-1,) + delta.shape[2:]))
    kw["groups"] = kw.get("groups", 1) * lanes
    got = tq.qconv(torch.from_numpy(_last(x, nhwc)), sc["s6"], sc["z6"], w,
                   sc["s1"], torch.from_numpy(b_d.reshape(-1)), sc["s7"],
                   sc["z7"], flipout=_epilogue(mean, block, cdim, sc), **kw)
    _equal(want, got)
    _clamps_as_named(want, scales)


def _clamps_as_named(out, scales):
    """Most outputs clamp under the "clamped" scales, few otherwise."""
    clamped = ((out == 0) | (out == 255)).mean()
    assert clamped > 0.5 if scales == "clamped" else clamped < 0.1, clamped
    assert len(np.unique(out)) > 2


@pytest.mark.parametrize("scales", list(SCALES))
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
@pytest.mark.parametrize("lanes", [1, 3])
def test_linear_epilogue_equals_the_jax_chain(scales, lead, lanes):
    """The perturbation's qlinear with the Flipout epilogue: one forward,
    and lanes on the last axis as the layer's draw axis runs them (a GEMM
    a lane, its columns of the mean)."""
    sc = SCALES[scales]
    rs = np.random.RandomState(7 * lanes + len(lead))
    K, N = 12, 7
    x = rs.randint(0, 256, lead + (lanes * K,)).astype(np.uint8)
    mu = rs.randint(-128, 128, (lanes, N, K)).astype(np.int8)
    delta = rs.randint(-128, 128, (lanes, N, K)).astype(np.int8)
    b_mu, b_d = (rs.randn(lanes, N).astype(np.float32) for _ in range(2))
    keys = list(jax.random.split(jax.random.key(3 + lanes), lanes))
    wants, means = [], []
    for s in range(lanes):
        xs = jnp.asarray(x[..., s * K:(s + 1) * K])
        mean = jq.qlinear(xs, sc["s6"], sc["z6"], jnp.asarray(mu[s]),
                          sc["w_mu"], jnp.asarray(b_mu[s]), sc["s3"],
                          sc["z3"])
        pert = jq.qlinear(xs, sc["s6"], sc["z6"], jnp.asarray(delta[s]),
                          sc["s1"], jnp.asarray(b_d[s]), sc["s7"], sc["z7"])
        wants.append(np.asarray(_jax_flipout(mean, pert, keys[s], sc)))
        means.append(np.asarray(mean))
    want = np.concatenate(wants, axis=-1)
    mean = torch.from_numpy(np.concatenate(means, axis=-1))
    salts = [_salt(k) for k in keys]
    one = lead + (N,)
    block = ts.sign_block(salts, one, axis=len(one) - 1) if lanes > 1 \
        else ts.sign_block(salts, one)
    epi = _epilogue(mean, block, -1, sc)
    got = torch.cat([tq.qlinear(
        torch.from_numpy(x[..., s * K:(s + 1) * K]), sc["s6"], sc["z6"],
        torch.from_numpy(delta[s]), sc["s1"], torch.from_numpy(b_d[s]),
        sc["s7"], sc["z7"],
        epi._replace(mean=mean[..., s * N:(s + 1) * N], lane=s))
        for s in range(lanes)], dim=-1)
    _equal(want, got)
    _clamps_as_named(want, scales)


# --- (b) the affine counter map against the SignBlock's counters -----------

def _block_forms():
    """(name, SignBlock, channel dim, GEMM column width) of every form a
    layer's output signs take."""
    salts = [ts.sign_salts(41, s)[1] for s in range(4)]
    forms = [("NCHW", ts.sign_block(salts[:1], (3, 8, 5, 7)), 1, 8),
             ("NHWC", ts.sign_block(salts[:1], (3, 5, 7, 8)), 3, 8),
             ("linear", ts.sign_block(salts[:1], (6, 10)), 1, 10),
             ("linear 3-D", ts.sign_block(salts[:1], (2, 3, 10)), 2, 10),
             ("NCHW groups", ts.sign_block(salts[:1], (3, 8, 5, 7)), 1, 2),
             ("NCHW lanes", ts.sign_block(salts, (3, 8, 5, 7), axis=1), 1,
              4),
             ("NHWC lanes", ts.sign_block(salts, (3, 5, 7, 8), axis=3), 3,
              8),
             ("linear lanes", ts.sign_block(salts, (6, 10), axis=1), 1, 10),
             ("3-D conv", ts.sign_block(salts[:2], (2, 4, 3, 3, 3), axis=1),
              1, 4)]
    with ts.draw_window(ts.DrawWindow(0, 4, 4, 4, 4, 12)):
        forms += [("window rows NCHW", ts.sign_block(salts, (4, 8, 5, 7),
                                                     axis=1), 1, 4),
                  ("window rows NHWC", ts.sign_block(salts[:1], (4, 5, 7, 8)),
                   3, 8)]
    with ts.tp_shard(1, 2, 1):
        forms.append(("shard NCHW", ts.sign_block(
            salts, (3, 8, 5, 7), axis=1, output=True), 1, 8))
    with ts.tp_shard(1, 3, -1):
        forms.append(("shard NHWC", ts.sign_block(
            salts[:1], (3, 5, 7, 8), output=True), 3, 8))
        forms.append(("shard linear", ts.sign_block(
            salts[:1], (6, 10), output=True), 1, 5))
    return forms


def _block_counters(block, cd, lane, ch0, n):
    """The counters of lane ``lane``'s channels [ch0, ch0 + n) from
    ``_lane_counters``, as the GEMM's (M, n) rows and columns."""
    ctr, base = kh._lane_counters(block)
    if block.axis is not None:
        ctr = ctr[:block.axis] + ctr[block.axis + 1:]
    shape = list(block.shape)
    shape[cd] = n
    idx = torch.full(shape, base, dtype=torch.int64)
    for d, size in enumerate(shape):
        at = torch.arange(size, dtype=torch.int64) + (ch0 if d == cd else 0)
        idx = idx + (at * ctr[d]).reshape(
            [-1 if e == d else 1 for e in range(len(shape))])
    return idx.movedim(cd, -1).reshape(-1, n)


def _map_signs(sm, M, N):
    """The f32 signs (M, N) of a ``SignMap`` as the kernel hashes them:
    bit 31 of splitmix32(salt + (c + 1) * GOLDEN)."""
    m = torch.arange(M)[:, None]
    c = sm.c0 + (m // sm.R) * sm.cb + (m % sm.R) * sm.cr \
        + torch.arange(N)[None, :] * sm.cn
    h = ts._mix(sm.salt, ((c & 0xFFFFFFFF) + 1).reshape(-1))
    return torch.where((h >> 31).bool(), -1.0, 1.0).reshape(M, N)


@pytest.mark.parametrize("form", range(14))
def test_sign_map_equals_the_blocks_counters(form):
    """Each GEMM's ``SignMap`` (every lane, every group of columns) gives
    every element the counter ``_lane_counters`` gives it (mod 2**32), its
    lane's salt, and the sign ``signs_plain`` draws there; its (M, N)
    hashed alone equals the GEMM's slice of the block's plain signs."""
    name, block, cd, width = _block_forms()[form]
    signs = kh.OutputSigns(block, cd)
    per_lane = block.shape[cd]
    for lane in range(len(block.salts)):
        for ch0 in range(0, per_lane, width):
            sm = signs.sign_map(lane, ch0)
            want = _block_counters(block, cd, lane, ch0, width)
            M = want.shape[0]
            m = torch.arange(M)[:, None]
            n = torch.arange(width)[None, :]
            got = sm.c0 + (m // sm.R) * sm.cb + (m % sm.R) * sm.cr \
                + n * sm.cn
            assert torch.equal(got % 2**32, want % 2**32), (name, lane, ch0)
            assert sm.salt == block.salts[lane] % 2**32
            plain = signs.gemm_plain(lane, ch0, width, None)
            assert torch.equal(_map_signs(sm, M, width), plain), \
                (name, lane, ch0)
            assert 0.3 < (plain < 0).float().mean() < 0.7


def test_sign_map_refuses_a_block_its_rows_cannot_walk():
    """A block cut on a dim the GEMM's rows walk past the first (here an
    LSTM-like block of a time window) has no affine map."""
    block = ts.SignBlock((5,), (2, 4, 3, 8), (5, 6, 3, 8), (1, 2, 0, 0))
    with pytest.raises(ValueError, match="not whole"):
        kh.OutputSigns(block, 3).sign_map(0, 0)


# --- (c) the input pass against JAX's requantize and qmul ------------------

QSIGN = [(0.031, 117.0, 0.0079, 127.0, 0.045, 121.0),
         (0.2, 128.0, 0.2, 128.0, 0.2, 128.0)]


@pytest.mark.parametrize("scales", range(2))
@pytest.mark.parametrize("shape,axis,shared", [
    ((2, 6, 5, 5), None, False), ((2, 5, 5, 6), None, False),
    ((2, 6, 5, 5), 1, False), ((2, 6, 5, 5), 1, True),
    ((2, 5, 5, 6), 3, False), ((4, 9), 1, True)])
@pytest.mark.parametrize("requant", [(0.057, 131), (0.0213, 0), None])
def test_input_pass_equals_jax_requantize_and_qmul(scales, shape, axis,
                                                  shared, requant):
    """K-H3's plain version with ``requant``: x_q equals JAX's
    ``QTensor.requantize`` of the payload (tiled over the lanes where the
    payload is shared) and the product equals JAX's ``qmul`` of x_q and the
    quantized signs; without a requantize (``requant`` None) the product
    of the payload as it is."""
    sa, za, ss, zs, so, zo = QSIGN[scales]
    lanes = 1 if axis is None else 3
    keys = list(jax.random.split(jax.random.key(9 + scales), lanes))
    block = ts.sign_block([_salt(k) for k in keys], shape, axis=axis)
    full = block.lanes_shape
    part = full if not shared else \
        full[:axis] + (1,) + full[axis + 1:]
    a = np.random.RandomState(len(shape) + scales).randint(
        0, 256, part).astype(np.uint8)
    if requant is None:
        x_q = np.broadcast_to(a, full)
        got = kh.qsign_mul(torch.from_numpy(a), sa, za, block, ss, zs, so, zo)
    else:
        jx = jqt.QTensor(jnp.asarray(a), *requant).requantize(sa, za)
        x_q = np.broadcast_to(np.asarray(jx.q), full)
        gx, got = kh.qsign_mul(torch.from_numpy(a), sa, za, block, ss, zs, so,
                               zo, requant=requant)
        _equal(x_q, gx)
        assert len(np.unique(x_q)) > 8
    if axis is None:
        signs = js.rademacher_fused(keys[0], shape, jnp.float32)
    else:
        signs = jnp.stack([js.rademacher_fused(k, shape, jnp.float32)
                           for k in keys], axis=axis)
    want = jq.qmul(jnp.asarray(x_q), sa, jq.quantize_uint8(signs, ss, zs),
                   ss, so, zo, a_zp=za, b_zp=zs, out_dtype=jnp.uint8)
    _equal(want, got)


def test_input_pass_at_equal_scales_is_the_plain_product():
    """A requantize to the payload's own scale and zero point changes
    nothing: the pass gives the payload and today's product."""
    block = ts.sign_block([ts.sign_salts(3)[0]], (2, 6, 5, 5))
    a = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 6, 5, 5)).astype(np.uint8))
    args = (0.031, 117, block, 0.0079, 127.0, 0.045, 121.0)
    x_q, y = kh.qsign_mul(a, *args, requant=(0.031, 117))
    assert torch.equal(x_q, a)
    assert torch.equal(y, kh.qsign_mul(a, *args))


# --- (d) the layer: the fused route against the injected-tensor route ------

LAYERS = {
    "conv": ("Conv2dFlipout", (6, 8, 3, 1, 1), (2, 6, 7, 7), {}),
    "conv-nhwc": ("Conv2dFlipout", (6, 8, 3, 1, 1), (2, 7, 7, 6),
                  dict(data_format="NHWC")),
    "grouped": ("Conv2dFlipout", (6, 8, 3, 1, 1, 1, 2), (2, 6, 7, 7), {}),
    "transposed": ("ConvTranspose2dFlipout", (6, 4, 4, 2, 1), (2, 6, 5, 5),
                   {}),
    "linear": ("LinearFlipout", (12, 7), (5, 12), {}),
}


def _quantized_layer(name, calibrated):
    from bayesian_torch_tpu_torch import layers as L
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn
    from bayesian_torch_tpu_torch.quantization import (
        freeze_quantized_draws, prepare)

    cls, args, shape, kw = LAYERS[name]
    layer = getattr(L, cls)(*args, generator=torch.Generator().manual_seed(0),
                            **kw)
    holder = nn.ModuleDict(dict(l=layer)).eval()
    prepare(holder)
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(
        np.float32))
    with torch.no_grad():
        holder["l"](x)
    bnn_to_qbnn(holder)
    freeze_quantized_draws(holder)
    layer = holder["l"]
    if not calibrated:
        layer.quant_dict = None
    layer.q_output = True
    return layer, x


def _counting(monkeypatch):
    """Count the epilogue's and K-H3's plain routes as their launches, and
    the ``int8.qadd`` calls made outside the epilogue's plain version."""
    counted = {"K-F flipout": 0, "K-H3": 0, "qadd": 0}
    inside = [False]
    real_epi, real_qadd = kf.qmatmul_requant_flipout_plain, tq.qadd
    real_qsign = kh.qsign_mul_plain

    def epi(*args, **kw):
        counted["K-F flipout"] += 1
        inside[0] = True
        try:
            return real_epi(*args, **kw)
        finally:
            inside[0] = False

    def qadd(*args, **kw):
        counted["qadd"] += not inside[0]
        return real_qadd(*args, **kw)

    def qsign(*args, **kw):
        counted["K-H3"] += 1
        return real_qsign(*args, **kw)

    monkeypatch.setattr(kf, "qmatmul_requant_flipout_plain", epi)
    monkeypatch.setattr(tq, "qadd", qadd)
    monkeypatch.setattr(kh, "qsign_mul_plain", qsign)
    return counted


@pytest.mark.parametrize("name", list(LAYERS))
@pytest.mark.parametrize("calibrated", [True, False])
@pytest.mark.parametrize("draws", [None, 2])
@pytest.mark.parametrize("qtensor", [True, False])
def test_layer_fused_route_equals_the_tensor_route(monkeypatch, name,
                                                   calibrated, draws,
                                                   qtensor):
    """On its ``SignBlock`` route a quantized Flipout layer runs no
    ``int8.qadd`` of its own, one K-F Flipout epilogue a perturbation GEMM
    (a group, a draw's group under the draw axis) and one K-H3 (the input
    pass; with a ``QTensor`` input of another scale its requantize too),
    and its uint8 output equals the route with the same signs injected as
    tensors (the torch route: qmul and qadd after the GEMM)."""
    layer, x = _quantized_layer(name, calibrated)
    if qtensor:
        x = QTensor(torch.from_numpy(np.random.RandomState(4).randint(
            0, 256, tuple(x.shape)).astype(np.uint8)), 0.037, 119)
    salts = [ts.sign_salts(77, s) for s in range(draws or 1)]
    monkeypatch.setattr(layer, "_sign_salts", lambda num_draws=None:
                        salts if num_draws else salts[0])
    groups = getattr(layer, "groups", 1)
    if draws:
        layer._mc_draws = draws
    counted = _counting(monkeypatch)
    with torch.no_grad():
        fused = layer(x, return_kl=False)
    assert counted == {"K-F flipout": groups * (draws or 1), "K-H3": 1,
                       "qadd": 0}
    x_shape = list(x.shape)
    if draws:
        x_shape[layer._draw_dim(len(x_shape))] *= draws
    sign_in = kh.signs_plain(layer._side_signs(
        salts if draws else salts[0], 0, x_shape, None, draws))
    sign_out = kh.signs_plain(layer._side_signs(
        salts if draws else salts[0], 1, fused.q.shape, None, draws))
    with torch.no_grad():
        tensors = layer(x, return_kl=False,
                        sign_in=sign_in.reshape(x_shape),
                        sign_out=sign_out.reshape(fused.q.shape))
    assert counted["qadd"] == 1
    assert (fused.scale, fused.zp) == (tensors.scale, tensors.zp)
    assert torch.equal(fused.q, tensors.q)
    assert len(torch.unique(fused.q)) > 8


# --- the launch arithmetic chip_smoke.py gates its INT8 Flipout paths by ----

@pytest.mark.parametrize("emission", ["scan", "vmap"])
def test_chip_smoke_int8_launch_counts_match_a_call(monkeypatch, emission):
    """``chip_smoke.int8_sign_launches`` and phase 38's K-F gates against
    the calls of a Flipout ``qresnet18`` MC-2 batch (calibrated, folded,
    uint8 activations), the plain routes counted as launches: one K-H3 a
    layer and forward, one plain K-F (the mean) and one K-F Flipout
    epilogue a layer and draw (a GEMM a draw under the draw axis), no
    torch ``qadd``."""
    import chip_smoke as cs
    from bayesian_torch_tpu_torch.models.bayesian.\
        quantized_resnet_flipout_large import qresnet18
    from bayesian_torch_tpu_torch.parallel import mc_forward

    def calibrate(model):
        with torch.no_grad():
            model(torch.randn(2, 3, 32, 32,
                              generator=torch.Generator().manual_seed(1)))

    m = qresnet18(num_classes=10, generator=torch.Generator().manual_seed(0),
                  calibrate=calibrate, fuse_conv_bn=True,
                  quantize_activations=True)
    layers = sum(hasattr(mod, "quant_dict") for mod in m.modules())
    counted = _counting(monkeypatch)
    plain_kf = [0]
    real_plain = kf.qmatmul_requant_plain

    def kf_plain(*args, **kw):
        plain_kf[0] += 1
        return real_plain(*args, **kw)

    monkeypatch.setattr(kf, "qmatmul_requant_plain", kf_plain)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        mc_forward(m, x, 2, return_kl=False, emission=emission)
    monkeypatch.setattr(cs, "INT8_LAYERS", layers)
    forwards = 2 if emission == "scan" else 1
    want = cs.int8_sign_launches(1, forwards)
    assert counted["K-H3"] == want["K-H3"] == layers * forwards
    assert counted["K-F flipout"] == 2 * layers
    # the plain K-F inside the epilogue's plain version counts there
    assert plain_kf[0] - counted["K-F flipout"] == 2 * layers
    assert counted["qadd"] == 0
