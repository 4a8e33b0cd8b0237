"""The per-draw GEMM (K-G) and the pointwise emission that launches it.

On the CPU the port's wrappers run K-G's plain version, so these tests
hold that plain version against the two Pallas kernels it replaces, run
in TPU interpret mode (``benchmarks/bench_1x1_mc.py::pallas_mc_gemm`` and
``benchmarks/bench_mosaic_matmul.py::pallas_matmul``), after the layout
change (B, S, C, P) <-> (M, S, C); the pointwise emission of
``ops/conv.py`` against the default route and against the JAX emission
(``conv_nd(..., data_format="NHWC", pointwise_dot=True)``); and the
gradients of both against ``jax.grad`` through that emission. Inputs come
from numpy seeds. Tolerances: f32 1e-5 (order of summation), bf16 one ulp
of the largest value (both accumulate in f32 and round once), int8 bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesian_torch_tpu.ops import conv as jconv
from bayesian_torch_tpu_torch.ops import conv as tconv
from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg
from tests._torch_port import to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _bf16_ulp_of_max(want):
    """One bf16 ulp (8 significant bits) of the largest |value|."""
    return float(2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))


def _rand(rs, shape, dtype):
    if dtype == "int8":
        return rs.randint(-128, 128, shape).astype(np.int8)
    return rs.randn(*shape).astype(np.float32)


_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,C,O,hw", [(2, 3, 16, 24, 8), (1, 2, 8, 8, 4)])
def test_plain_matches_pallas_mc_gemm(dtype, B, S, C, O, hw):
    from benchmarks.bench_1x1_mc import pallas_mc_gemm

    rs = np.random.RandomState(0)
    P = hw * hw
    x = _rand(rs, (B, S, C, P), dtype)
    w = _rand(rs, (S, O, C), dtype)
    got = kg.mc_gemm(torch.from_numpy(x).to(_TORCH[dtype]),
                     torch.from_numpy(w).to(_TORCH[dtype]))
    assert got.shape == (B, S, O, P) and got.dtype == _TORCH[dtype]
    xj = jnp.asarray(x.transpose(0, 3, 1, 2).reshape(B * P, S, C),
                     _JAX[dtype])
    wj = jnp.asarray(w.transpose(0, 2, 1), _JAX[dtype])
    with pltpu.force_tpu_interpret_mode():
        want = pallas_mc_gemm(xj, wj, 128, 256, 512)
    want = np.asarray(want.astype(jnp.float32)).reshape(B, P, S, O)
    want = want.transpose(0, 2, 3, 1)
    if dtype == "f32":
        np.testing.assert_allclose(to_np(got), want, **TOL)
    else:
        assert np.abs(to_np(got) - want).max() <= _bf16_ulp_of_max(want)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_plain_matches_pallas_matmul(dtype):
    """The tiled-GEMM probe is K-G at S = 1, B = 1: (M, K) @ (K, N) is
    w (1, M, K), x (1, 1, K, N)."""
    from benchmarks.bench_mosaic_matmul import pallas_matmul

    rs = np.random.RandomState(1)
    M, K, N = 32, 64, 48
    a, b = _rand(rs, (M, K), dtype), _rand(rs, (K, N), dtype)
    got = kg.matmul(torch.from_numpy(a).to(_TORCH[dtype]),
                    torch.from_numpy(b).to(_TORCH[dtype]))
    with pltpu.force_tpu_interpret_mode():
        want = pallas_matmul(jnp.asarray(a, _JAX[dtype]),
                             jnp.asarray(b, _JAX[dtype]), 16, 16, 32)
    assert got.shape == (M, N)
    if dtype == "int8":
        assert got.dtype == torch.int32 and want.dtype == jnp.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(to_np(got), want, **TOL)
    else:
        assert np.abs(to_np(got) - want).max() <= _bf16_ulp_of_max(want)


def test_shared_operands_are_broadcasts_of_the_same_product():
    rs = np.random.RandomState(2)
    B, S, C, O, P = 2, 3, 5, 4, 7
    x = torch.from_numpy(_rand(rs, (B, S, C, P), "f32"))
    w = torch.from_numpy(_rand(rs, (S, O, C), "f32"))
    bias = torch.from_numpy(_rand(rs, (S, O), "f32"))
    full = kg.mc_gemm(x, w, bias)
    want = torch.einsum("soc,bscp->bsop", w, x) + bias[None, :, :, None]
    torch.testing.assert_close(full, want, **TOL)
    # one input for all draws
    shared = kg.mc_gemm(x[:, 0].contiguous(), w, bias)
    torch.testing.assert_close(
        shared, kg.mc_gemm(x[:, :1].expand(B, S, C, P).contiguous(), w, bias))
    # one weight for the whole batch
    one = kg.pointwise_gemm(x.reshape(B * S, C, P), w[0], bias[0])
    torch.testing.assert_close(
        one.reshape(B, S, O, P),
        kg.mc_gemm(x, w[:1].expand(S, O, C).contiguous(),
                   bias[:1].expand(S, O).contiguous()))


def test_bias_is_added_in_the_output_type_after_the_cast():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(_rand(rs, (2, 2, 6, 9), "f32")).bfloat16()
    w = torch.from_numpy(_rand(rs, (2, 3, 6), "f32")).bfloat16()
    bias = torch.from_numpy(_rand(rs, (2, 3), "f32")).bfloat16()
    got = kg.mc_gemm(x, w, bias)
    want = kg.mc_gemm(x, w) + bias[None, :, :, None]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x, w = torch.zeros(2, 3, 4, 5), torch.zeros(3, 6, 4)
    with pytest.raises(ValueError):
        kg.mc_gemm(x, w.double())
    with pytest.raises(ValueError):
        kg.mc_gemm(x[:, :2], w)
    with pytest.raises(ValueError):
        kg.mc_gemm(x, w, torch.zeros(6))
    with pytest.raises(ValueError):
        kg.mc_gemm(x, w[0])
    with pytest.raises(ValueError):
        kg.pointwise_gemm(x, w[0])
    with pytest.raises(ValueError):
        kg.mc_gemm(x.to(torch.int8), w.to(torch.int8), torch.zeros(3, 6))
    with pytest.raises(ValueError):
        kg.matmul(torch.zeros(2, 3), torch.zeros(4, 5))


def _jax_lanes(x, w, b, hw):
    """The JAX pointwise emission over draws: lane s is
    ``conv_nd(x_s, w_s, b_s, pointwise_dot=True)`` in NHWC (the layout in
    which JAX takes the dot route), with x (B, Sx, C, H*W), w (Sw, O, C)
    and b (Sb, O) or None; a lane count of 1 is shared by the draws.
    Returns (B, S, O, H*W)."""
    B, Sx, C, P = x.shape
    S = max(Sx, w.shape[0])
    lanes = []
    for s in range(S):
        xs = x[:, s % Sx].reshape(B, C, *hw).transpose(0, 2, 3, 1)
        ws = w[s % w.shape[0]].reshape(w.shape[1], C, 1, 1)
        bs = None if b is None else b[s % b.shape[0]]
        y = jconv.conv_nd(xs, ws, bs, data_format="NHWC",
                          pointwise_dot=True)
        lanes.append(y.transpose(0, 3, 1, 2).reshape(B, -1, P))
    return jnp.stack(lanes, axis=1)


# (wrapper, x lanes, w lanes, bias lanes or None): per draw, a shared input,
# a shared weight, and the one-weight wrapper with and without a bias
_GRAD_CASES = [("mc_gemm", 3, 3, 3), ("mc_gemm", 1, 3, 3),
               ("mc_gemm", 3, 1, 1), ("mc_gemm", 3, 3, None),
               ("pointwise_gemm", 1, 1, 1), ("pointwise_gemm", 1, 1, None)]


@pytest.mark.parametrize("wrapper,sx,sw,sb", _GRAD_CASES)
def test_gradients_match_jax(wrapper, sx, sw, sb):
    """K-G trains: the gradients of both wrappers in x, w and the bias
    equal ``jax.grad`` through the JAX ``conv_nd(pointwise_dot=True)`` on
    the same inputs and cotangent; f32, 1e-5 (order of summation)."""
    import jax

    rs = np.random.RandomState(6)
    B, C, O, hw = 2, 6, 5, (4, 3)
    P, S = hw[0] * hw[1], max(sx, sw)
    x = _rand(rs, (B, sx, C, P), "f32")
    w = _rand(rs, (sw, O, C), "f32")
    b = None if sb is None else _rand(rs, (sb, O), "f32")
    cot = _rand(rs, (B, S, O, P), "f32")

    def loss(x, w, b):
        return (_jax_lanes(x, w, b, hw) * cot).sum()

    want = jax.grad(loss, argnums=(0, 1) if b is None else (0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    tx = torch.from_numpy(x[:, 0] if sx == 1 else x).requires_grad_(True)
    tw = torch.from_numpy(w[0] if wrapper == "pointwise_gemm" else w)
    tw.requires_grad_(True)
    tb = None
    if b is not None:
        tb = torch.from_numpy(b[0] if wrapper == "pointwise_gemm" else b)
        tb.requires_grad_(True)
    y = getattr(kg, wrapper)(tx, tw, tb)
    (y.reshape(cot.shape) * torch.from_numpy(cot)).sum().backward()
    got = [tx.grad, tw.grad] + ([] if tb is None else [tb.grad])
    for name, g, v in zip("xwb", got, want):
        np.testing.assert_allclose(to_np(g).reshape(v.shape), np.asarray(v),
                                   **TOL, err_msg=name)


@pytest.mark.parametrize("shared", [False, True])
def test_pointwise_conv_ops_train_as_jax(shared):
    """``conv_draws`` and ``conv_nd`` with ``pointwise_dot=True`` are
    differentiable: their gradients equal JAX's through the same emission
    (f32, 1e-5), and the default route's."""
    import jax

    rs = np.random.RandomState(7)
    S, B, C, O, hw = 3, 2, 6, 4, (5, 3)
    x = _rand(rs, (B, (1 if shared else S) * C) + hw, "f32")
    w = _rand(rs, (S, O, C, 1, 1), "f32")
    b = _rand(rs, (S, O), "f32")
    cot = _rand(rs, (B, S * O) + hw, "f32")

    def jloss(x, w, b):
        y = _jax_lanes(x.reshape(B, -1, C, hw[0] * hw[1]),
                       w.reshape(S, O, C), b, hw)
        return (y.reshape(cot.shape) * cot).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    grads = {}
    for dot in (True, False):
        t = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
        y = tconv.conv_draws(*t, pointwise_dot=dot)
        (y * torch.from_numpy(cot)).sum().backward()
        grads[dot] = [a.grad for a in t]
    for got, default, v in zip(grads[True], grads[False], want):
        np.testing.assert_allclose(to_np(got), np.asarray(v), **TOL)
        torch.testing.assert_close(got, default, **TOL)
    # the single-weight op: one draw of the same weights
    t = [torch.from_numpy(a).requires_grad_(True)
         for a in (x[:, :C], w[0], b[0])]
    (tconv.conv_nd(*t, pointwise_dot=True)
     * torch.from_numpy(cot[:, :O])).sum().backward()
    want = jax.grad(lambda *a: (_jax_lanes(
        a[0].reshape(B, 1, C, -1), a[1].reshape(1, O, C), a[2][None], hw)
        .reshape(B, O, *hw) * cot[:, :O]).sum(), argnums=(0, 1, 2))(
        jnp.asarray(x[:, :C]), jnp.asarray(w[0]), jnp.asarray(b[0]))
    for g, v in zip(t, want):
        np.testing.assert_allclose(to_np(g.grad), np.asarray(v), **TOL)


def test_bf16_gradients_flow_in_the_compute_dtype():
    """Under a bf16 compute dtype the gradients come back in each
    operand's own dtype, within four bf16 ulps of the largest value of
    the f32 route's (roundings of the operands, of the product, of its
    gradient and of the input gradient; 1.6 ulps at most over five
    seeds)."""
    rs = np.random.RandomState(8)
    x = torch.from_numpy(_rand(rs, (2, 3 * 8, 4, 4), "f32"))
    w = torch.from_numpy(_rand(rs, (3, 5, 8, 1, 1), "f32"))
    grads = {}
    for dtype in (None, torch.bfloat16):
        t = [a.clone().requires_grad_(True) for a in (x, w)]
        tconv.conv_draws(*t, compute_dtype=dtype,
                         pointwise_dot=True).float().square().sum().backward()
        assert all(a.grad.dtype == torch.float32 for a in t)
        grads[dtype] = [a.grad for a in t]
    for got, want in zip(grads[torch.bfloat16], grads[None]):
        ulp = _bf16_ulp_of_max(to_np(want))
        assert (got - want).abs().max().item() <= 4 * ulp


@pytest.mark.parametrize("nd,sp", [(1, (11,)), (2, (5, 6)), (3, (3, 4, 2))])
@pytest.mark.parametrize("bias", [False, True])
def test_pointwise_conv_matches_default_route_and_jax(nd, sp, bias):
    rs = np.random.RandomState(4)
    x = _rand(rs, (2, 6) + sp, "f32")
    w = _rand(rs, (5, 6) + (1,) * nd, "f32")
    b = _rand(rs, (5,), "f32") if bias else None
    tb = None if b is None else torch.from_numpy(b)
    got = tconv.conv_nd(torch.from_numpy(x), torch.from_numpy(w), tb,
                        pointwise_dot=True)
    default = tconv.conv_nd(torch.from_numpy(x), torch.from_numpy(w), tb)
    torch.testing.assert_close(got, default, **TOL)
    last = tuple(range(2, 2 + nd)) + (1,)
    want = jconv.conv_nd(
        jnp.asarray(x.transpose((0,) + last)), jnp.asarray(w),
        None if b is None else jnp.asarray(b),
        data_format="N" + "DHW"[3 - nd:] + "C", pointwise_dot=True)
    want = np.moveaxis(np.asarray(want), -1, 1)
    np.testing.assert_allclose(to_np(got), want, **TOL)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_pointwise_conv_draws_matches_default_route(shared, compute_dtype):
    rs = np.random.RandomState(5)
    S, B, C, O = 3, 2, 6, 4
    x = torch.from_numpy(_rand(rs, (B, C if shared else S * C, 8, 8), "f32"))
    w = torch.from_numpy(_rand(rs, (S, O, C, 1, 1), "f32"))
    b = torch.from_numpy(_rand(rs, (S, O), "f32"))
    got = tconv.conv_draws(x, w, b, compute_dtype=compute_dtype,
                           pointwise_dot=True)
    want = tconv.conv_draws(x, w, b, compute_dtype=compute_dtype)
    assert got.shape == want.shape == (B, S * O, 8, 8)
    assert got.dtype == want.dtype
    if compute_dtype is None:
        torch.testing.assert_close(got, want, **TOL)
    else:
        # both round an f32 sum to bf16, then add the bf16 bias
        ulp = _bf16_ulp_of_max(to_np(want))
        assert (got.float() - want.float()).abs().max().item() <= 2 * ulp


def _counting(monkeypatch):
    calls = {"pointwise_gemm": 0, "mc_gemm": 0}
    for name in calls:
        real = getattr(kg, name)

        def spy(*a, _name=name, _real=real, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kg, name, spy)
    return calls


def test_default_is_off_and_only_pointwise_convs_take_the_emission(
        monkeypatch):
    calls = _counting(monkeypatch)
    assert tconv.CONV_1X1_DOT is False
    x = torch.randn(2, 4, 6, 6)
    w1, w3 = torch.randn(5, 4, 1, 1), torch.randn(5, 4, 3, 3)
    tconv.conv_nd(x, w1)
    assert calls["pointwise_gemm"] == 0
    want = {}
    for name, w, kw in (("k3", w3, dict(padding=1)),
                        ("stride", w1, dict(stride=2)),
                        ("pad", w1, dict(padding=1)),
                        ("same", w1, dict(padding="SAME")),
                        ("dilation", w1, dict(dilation=2)),
                        ("groups", torch.randn(4, 2, 1, 1), dict(groups=2))):
        want[name] = tconv.conv_nd(x, w, **kw)
        got = tconv.conv_nd(x, w, pointwise_dot=True, **kw)
        assert torch.equal(got, want[name]), name
    assert calls["pointwise_gemm"] == 0
    tconv.conv_nd(x, w1, pointwise_dot=True)
    assert calls == {"pointwise_gemm": 1, "mc_gemm": 0}
    # the module default is what the layers inherit
    monkeypatch.setattr(tconv, "CONV_1X1_DOT", True)
    tconv.conv_nd(x, w1)
    tconv.conv_draws(x, w1[None].repeat(3, 1, 1, 1, 1))
    assert calls == {"pointwise_gemm": 2, "mc_gemm": 1}
    tconv.conv_nd(x, w1, pointwise_dot=False)
    assert calls == {"pointwise_gemm": 2, "mc_gemm": 1}


def test_shape_set_restricts_the_emission(monkeypatch):
    calls = _counting(monkeypatch)
    x = torch.randn(1, 4, 3, 3)
    only = frozenset({(4, 5)})  # (in_ch, out_ch) pairs, as in JAX
    tconv.conv_nd(x, torch.randn(5, 4, 1, 1), pointwise_dot=only)
    tconv.conv_nd(x, torch.randn(6, 4, 1, 1), pointwise_dot=only)
    tconv.conv_draws(x, torch.randn(2, 5, 4, 1, 1), pointwise_dot=only)
    tconv.conv_draws(x, torch.randn(2, 6, 4, 1, 1), pointwise_dot={(4, 7)})
    assert calls == {"pointwise_gemm": 1, "mc_gemm": 1}
    w = jnp.zeros((5, 4, 1, 1))
    assert jconv._is_pointwise(w, (1, 1), [(0, 0)] * 2, (1, 1), 1, "NHWC",
                               only)
    assert tconv._is_pointwise(torch.zeros(5, 4, 1, 1), 1, 0, 1, 1, only)
    assert not tconv._is_pointwise(torch.zeros(6, 4, 1, 1), 1, 0, 1, 1, only)


def test_layers_inherit_the_module_default(monkeypatch):
    """As in JAX the layers take no argument: a Bayesian 1x1 conv goes to
    K-G when ``CONV_1X1_DOT`` is set, in a single forward and under the
    draw axis, and gives what the default route gives."""
    import bayesian_torch_tpu_torch.layers as tl

    calls = _counting(monkeypatch)
    layer = tl.Conv2dReparameterization(
        4, 5, 1, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 6, 6)
    eps_k, eps_b = torch.randn(5, 4, 1, 1), torch.randn(5)
    with torch.no_grad():
        want = layer(x, eps_k=eps_k, eps_b=eps_b)[0]
        layer._presampled_w = torch.randn(3, 5, 4, 1, 1)
        layer._presampled_b = torch.randn(3, 5)
        layer._mc_draws = 3
        want_draws = layer(x)[0]
        monkeypatch.setattr(tconv, "CONV_1X1_DOT", True)
        got_draws = layer(x)[0]
        del layer._mc_draws, layer._presampled_w, layer._presampled_b
        got = layer(x, eps_k=eps_k, eps_b=eps_b)[0]
    assert calls == {"pointwise_gemm": 1, "mc_gemm": 1}
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got_draws, want_draws, **TOL)
