"""Converted INT8 models under the draw axis (``mc_forward(emission=
"vmap")``): the quantized layers of both estimators, ``QuantizedBatchNorm2d``
and the quantized LSTM cell.

- The draw axis against the port's own loop: the converted SCNN and the
  narrow ResNet (``tests/test_torch_port_quant.py::TorchQTiny``), each
  estimator, calibrated and not, with and without frozen draws; both
  emissions read the same presample record (the generators rewound between
  them), so Flipout's signs come from the same salts, and the outputs
  (dequantized from uint8 at one scale) are equal bit for bit.
- Each lane against JAX: the narrow ResNet with JAX's int8 state carried
  across (``utils.checkpoint.load_jax_quant_state``), lane s holding the
  s-th draw JAX froze (and, for Flipout, the signs JAX's s-th forward
  took); the bounds of ``test_prepare_calibrate_convert_matches_jax``:
  within 3 head quanta, at least 90 % of the logits equal.
- ``tests/test_quantization.py``'s SCNN flow through the vmap emission.
- The quantized LSTM regressor: the draw axis equals the loop with the
  cell's noise injected.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_torch_tpu_torch.layers.quantized_base import (NORMAL_SCALE,
                                                             _QuantizedLayerBase)
from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh
from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf
from bayesian_torch_tpu_torch.ops.sampling import module_generators
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.quantization import (convert,
                                                   freeze_quantized_draws,
                                                   prepare,
                                                   unfreeze_quantized_draws)
from tests import _torch_port as tp
from tests.test_torch_port_int8_flipout import _Signs
from tests.test_torch_port_quant import (_images, _jax_quant_state,
                                         _qtiny_twins, _t)

S = 3


@pytest.fixture(autouse=True)
def count_kf(monkeypatch):
    """K-F's plain version bumps the kernel's counter, as a launch would
    on the card."""
    plain = kf.qmatmul_requant_plain

    def counted(*args, **kw):
        kf.qmatmul_requant.launches += 1
        return plain(*args, **kw)

    monkeypatch.setattr(kf, "qmatmul_requant_plain", counted)


def _scnn(estimator, seed):
    from bayesian_torch_tpu_torch.models import _scnn
    cls = type("SCNN", (_scnn._SCNN,), {"estimator": estimator})
    return cls(generator=torch.Generator().manual_seed(seed)).eval()


def _converted(kind, estimator, calibrated, seed=16):
    """The converted SCNN or narrow ResNet (conv+BN folding and uint8
    activations for the ResNet), and an input."""
    if kind == "scnn":
        model = _scnn(estimator, seed)
        x = torch.from_numpy(np.random.RandomState(seed).randn(
            2, 1, 28, 28).astype(np.float32))
        calib = [x]
    else:
        _, model = _qtiny_twins(seed=seed, mu_scale=0.3, estimator=estimator)
        x = _t(_images(50))
        calib = [_t(_images(40 + i)) for i in range(2)]
    prepare(model)
    if calibrated:
        with torch.no_grad():
            for xb in calib:
                model(xb)
    convert(model, fuse_conv_bn=kind != "scnn", quantize_activations=True)
    return model, x


def _both_emissions(model, x):
    """(loop, draw axis) outputs on the same presample record: the
    generators are rewound before each."""
    gens = module_generators(model)
    states = [g.get_state() for g in gens]
    outs = []
    for emission in ("scan", "vmap"):
        for g, st in zip(gens, states):
            g.set_state(st)
        outs.append(tmc.mc_forward(model, x, S, return_kl=False,
                                   presample="on", emission=emission))
    return outs


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("calibrated", [True, False])
@pytest.mark.parametrize("estimator", [tp.REPARAM, tp.FLIPOUT])
@pytest.mark.parametrize("kind", ["scnn", "resnet"])
def test_draw_axis_equals_the_loop_bit_for_bit(kind, estimator, calibrated,
                                               frozen):
    model, x = _converted(kind, estimator, calibrated)
    assert tmc._draw_axis_refusal(model) is None
    layers = [m for m in model.modules()
              if isinstance(m, _QuantizedLayerBase)]
    if frozen:
        assert freeze_quantized_draws(model) == len(layers)
    kf.qmatmul_requant.launches = 0
    loop, draws = _both_emissions(model, x)
    assert loop.shape == draws.shape == (S, x.shape[0], 10)
    assert torch.equal(loop, draws)
    # the same K-F GEMMs: one a layer (Flipout: two) a draw, each way
    per_draw = len(layers) * (2 if estimator == tp.FLIPOUT else 1)
    assert kf.qmatmul_requant.launches == 2 * S * per_draw
    if calibrated and not frozen:  # the draws differ
        assert not torch.equal(draws[0], draws[1])
    for layer in layers:  # the record is gone after the call
        assert not any(k.startswith("_presampled") for k in vars(layer))


def test_draw_axis_takes_a_qtensor_and_a_shared_input_per_layer():
    """One quantized conv and one quantized linear under ``_mc_draws``: a
    shared input, its S-fold tiling and a ``QTensor`` give the same
    blocks, each block the layer's single forward on that draw's frozen
    weight; the K-F launches are the loop's (a GEMM a draw a group)."""
    from bayesian_torch_tpu_torch.ops.qtensor import QTensor

    model, _ = _converted("resnet", tp.REPARAM, True)
    conv, fc = model.layer1[0].conv2, model.fc
    rs = np.random.RandomState(3)
    for layer, shape in ((conv, (2, 8, 4, 4)), (fc, (2, 32))):
        x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        record = layer.presample(S)
        want = []
        for s in range(S):
            for name, v in record.items():
                setattr(layer, name, v[s])
            want.append(layer(x, return_kl=False))
        for name, v in record.items():
            setattr(layer, name, v)
        layer._mc_draws = S
        kf.qmatmul_requant.launches = 0
        try:
            shared = layer(x, return_kl=False)
            launches = kf.qmatmul_requant.launches
            dim = 1
            tiled = layer(torch.cat([x] * S, dim=dim), return_kl=False)
            q = QTensor(torch.randint(0, 256, shape, dtype=torch.uint8),
                        0.05, 128)
            from_q = layer(q, return_kl=False)
        finally:
            del layer._mc_draws
            for name in record:
                delattr(layer, name)
        assert launches == S * getattr(layer, "groups", 1)
        got = shared.q if isinstance(shared, QTensor) else shared
        blocks = got.reshape(got.shape[0], S, -1, *got.shape[2:])
        for s in range(S):
            w = want[s].q if isinstance(want[s], QTensor) else want[s]
            assert torch.equal(blocks[:, s], w)
        other = tiled.q if isinstance(tiled, QTensor) else tiled
        assert torch.equal(other, got)
        assert from_q.shape == got.shape


def test_calibration_is_still_refused_under_the_draw_axis():
    _, model = _qtiny_twins(seed=16, mu_scale=0.3)
    prepare(model)
    name, _ = tmc._draw_axis_refusal(model)
    assert name == "conv1"
    with pytest.raises(NotImplementedError, match="'conv1'"):
        tmc.mc_forward(model, _t(_images(40)), S, emission="vmap")


# --- each lane against JAX ------------------------------------------------

PER_FORWARD = 18  # the narrow ResNet's 9 Flipout layers, two signs each
LANES = 2


@pytest.mark.parametrize("estimator", [tp.REPARAM, tp.FLIPOUT])
def test_each_lane_equals_jax_with_its_draw_carried(monkeypatch, estimator):
    from bayesian_torch_tpu.ops import sampling as jsampling
    from bayesian_torch_tpu.quantization import (
        convert as jconvert, freeze_quantized_draws as jfreeze,
        prepare as jprepare)
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state

    jm, tm = _qtiny_twins(seed=17, mu_scale=0.3, estimator=estimator)
    jprepare(jm), prepare(tm)
    for i in range(2):
        jm(jnp.asarray(_images(20 + i)))
        with torch.no_grad():
            tm(_t(_images(20 + i)))
    jconvert(jm, fuse_conv_bn=True, quantize_activations=True)
    convert(tm, fuse_conv_bn=True, quantize_activations=True)
    flip = estimator == tp.FLIPOUT
    src = _Signs()
    if flip:
        monkeypatch.setattr(jsampling, "rademacher_fused", src.jax)
    x = _images(30)
    wants, lanes = [], []
    for s in range(LANES):
        jfreeze(jm)
        src.calls = s * PER_FORWARD
        wants.append(np.asarray(jm(jnp.asarray(x))[0]))
        lanes.append(_jax_quant_state(jm))
    load_jax_quant_state(tm, *lanes[0])  # the int8 state and quant_dicts
    unfreeze_quantized_draws(tm)  # the lanes come from the record
    names = {m: n for n, m in tm.named_modules()
             if isinstance(m, _QuantizedLayerBase)}

    def record(layer):
        arrays = [lane[0] for lane in lanes]
        name = names[layer]
        rec = {"_presampled_qw": torch.from_numpy(np.stack(
                   [a[f"{name}._frozen_w"] for a in arrays])),
               "_presampled_qscale": [np.float32(a[f"{name}._frozen_wscale"])
                                      for a in arrays],
               "_presampled_qnscale": [NORMAL_SCALE] * LANES}
        if f"{name}._frozen_bias" in arrays[0]:
            rec["_presampled_qbias"] = torch.from_numpy(np.stack(
                [a[f"{name}._frozen_bias"] for a in arrays]))
        return rec

    monkeypatch.setattr(tmc, "_presample_layers", lambda model, num_mc: [
        (layer, record(layer)) for layer in names])
    calls = []

    def lanes_of_jax_signs(salts, shape, dtype=torch.float32, device=None,
                           axis=1):
        """Lane s: the signs of JAX's s-th forward at this call."""
        i = len(calls)
        calls.append(i)
        signs = []
        for s in range(LANES):
            src.calls = s * PER_FORWARD + i
            signs.append(src(shape))
        return torch.from_numpy(np.stack(signs, axis=axis)).to(dtype)

    monkeypatch.setattr(
        kh, "signs_plain", lambda block, dtype=torch.float32, device=None:
        lanes_of_jax_signs(block.salts, block.shape, dtype, device,
                           axis=block.axis))
    got = tmc.mc_forward(tm, _t(x), LANES, return_kl=False, presample="on",
                         emission="vmap").numpy()
    assert len(calls) == (PER_FORWARD if flip else 0)
    head_q = tm.fc.quant_dict[9 if flip else 4]["scale"]
    for s in range(LANES):
        diff = np.abs(got[s] - wants[s])
        assert np.abs(wants[s]).max() > 0.1
        assert diff.max() <= 3 * head_q * (1 + 1e-6), (s, diff.max() / head_q)
        assert (diff == 0).mean() >= 0.9
    assert not np.array_equal(got[0], got[1])


# --- JAX's SCNN flow, and the quantized LSTM --------------------------------


def test_scnn_qtensor_flow_through_the_vmap_emission():
    """``tests/test_quantization.py::test_qtensor_flow_composes_with_
    mc_forward`` on the port, through the draw axis: the uint8 flow of a
    converted SCNN (no calibration) rides the channel blocks, and the
    draws stay independent per lane."""
    from bayesian_torch_tpu_torch.models.bayesian.simple_cnn_variational \
        import SCNN

    m = SCNN(generator=torch.Generator().manual_seed(0)).eval()
    prepare(m)
    convert(m, quantize_activations=True)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 1, 28, 28)
                         .astype(np.float32))
    outs = tmc.mc_forward(m, x, 3, return_kl=False, emission="vmap")
    assert outs.shape == (3, 4, 10)
    assert not torch.allclose(outs[0], outs[1])


def test_quantized_lstm_draw_axis_equals_the_loop(monkeypatch):
    """The converted regressor (``bnn_to_qbnn``): with the cell's eps_w and
    eps_b injected (draw s in the loop's s-th forward, all S stacked
    under the axis) and the head on one presample record, the draw axis
    equals the loop."""
    from bayesian_torch_tpu_torch.examples.main_bayesian_lstm_timeseries \
        import BayesianLSTMRegressor
    from bayesian_torch_tpu_torch.layers import rnn_base
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn

    H, B, T = 6, 3, 7
    model = BayesianLSTMRegressor(
        H, tp.REPARAM, generator=torch.Generator().manual_seed(31)).eval()
    bnn_to_qbnn(model)
    rs = np.random.RandomState(32)
    blocks = (model.lstm.ih, model.lstm.hh)
    stacked = dict(
        eps_w=tuple(torch.from_numpy(rs.randn(
            S, *b.quantized_mu_weight.shape).astype(np.float32))
            for b in blocks),
        eps_b=tuple(torch.from_numpy(rs.randn(S, 4 * H).astype(np.float32))
                    for b in blocks))
    per_draw = [{k: tuple(a[s] for a in v) for k, v in stacked.items()}
                for s in range(S)]
    forward = rnn_base._BaseLSTMLayer.forward
    calls = []

    def table_forward(self, X, hidden_states=None, return_kl=True):
        if getattr(self, "_mc_draws", None):
            return forward(self, X, hidden_states, return_kl, **stacked)
        calls.append(1)
        return forward(self, X, hidden_states, return_kl,
                       **per_draw[len(calls) - 1])

    monkeypatch.setattr(rnn_base._BaseLSTMLayer, "forward", table_forward)
    X = torch.from_numpy(rs.randn(B, T, 1).astype(np.float32))
    kf.qmatmul_requant.launches = 0
    loop, draws = _both_emissions(model, X)
    assert len(calls) == S
    assert kf.qmatmul_requant.launches == 2 * S  # the head: one a draw
    assert draws.shape == loop.shape == (S, B, T, 2)
    torch.testing.assert_close(draws, loop, rtol=0, atol=0)
