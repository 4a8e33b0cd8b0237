"""The port's small-model zoo against the JAX package, on the CPU: the MNIST
SCNN (28x28) and the CIFAR ResNet-20 (run at 16x16 to keep the suite
fast), each deterministic, reparameterization and Flipout, at batch 2.

- Forwards on the same weights (the JAX model is built abstractly with
  ``nnx.eval_shape`` and given the weights; its eager random init would
  take about 20 s for the ResNet): the deterministic forms directly; the
  reparameterization forms through ``mc_forward`` on the same injected
  draws (both of the port's emissions against the JAX vmap emission);
  the Flipout forms with every layer's eps and signs injected in both
  packages, at the ordinary rho of ``zoo_state``. Outputs within 1e-4 x
  max|output|, the KL within 1e-5 relative.
- The draw axis: the vmap emission equals the draw loop lane for lane on
  the same draws, for the ResNet (the option-A shortcut pads each draw's
  channel block) and the SCNN (log_softmax within each draw's block, so
  each lane's probabilities sum to 1), in eval mode and, for the ResNet,
  through one ELBO training step (loss and every gradient).
- The option-A shortcut on floats and on ``QTensor``s (padded with the
  zero point) against the JAX function; the seeded ``Dropout2d``.
- INT8: the CIFAR ResNet prepared, calibrated and converted with conv+BN
  folding and uint8 activations (the QTensor flows through the shortcut)
  in both packages; with JAX's int8 state and frozen draws carried across
  the logits agree to a few head quanta.
- The factories: every depth (20..110) in every form, the ResNet-110's
  111 Bayesian weight tensors (109 convs, the head's weight and bias).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from bayesian_torch_tpu.models import _cifar_resnet as jcifar
from bayesian_torch_tpu.models import get_kl_loss as jax_get_kl_loss
from bayesian_torch_tpu.nn import functional as jF
from bayesian_torch_tpu.parallel import mc as jmc
from bayesian_torch_tpu.utils.checkpoint import _torch_key_for
from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.layers.dropout import Dropout2d
from bayesian_torch_tpu_torch.models import _cifar_resnet as tcifar
from bayesian_torch_tpu_torch.models import get_kl_loss
from bayesian_torch_tpu_torch.models.dnn_to_bnn import iter_bayesian_layers
from bayesian_torch_tpu_torch.ops.qtensor import QTensor
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
from tests._torch_port import (FLIPOUT, REPARAM, draw_noise, inject_draws,
                               random_state, set_jax_eval, to_np)

S = 2
FORMS = [None, REPARAM, FLIPOUT]


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def zoo_state(arrays, seed=0, rho=None):
    """``random_state`` with every conv and linear weight (``weight``,
    ``mu_kernel``, ``mu_weight``) N(0, sqrt(2 / fan_in)), so activations
    stay of order 1 through the depth."""
    out = random_state(arrays, seed=seed, rho=rho)
    rs = np.random.RandomState(seed + 100)
    for key, a in arrays.items():
        shape = np.shape(a)
        name = key.rsplit(".", 1)[-1]
        if name in ("weight", "mu_weight", "mu_kernel") and len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            out[key] = rs.normal(0, math.sqrt(2.0 / fan_in),
                                 shape).astype(np.float32)
    return out


def _model(kind, form, package):
    """(jax factory taking rngs, torch factory taking a generator)."""
    if kind == "scnn":
        if package == "jax":
            from bayesian_torch_tpu.models import _scnn as mod
        else:
            from bayesian_torch_tpu_torch.models import _scnn as mod
        cls = type("SCNN", (mod._SCNN,), {"estimator": form})
        return (lambda r: cls(rngs=r)) if package == "jax" else \
            (lambda g: cls(generator=g))
    mod = jcifar if package == "jax" else tcifar
    factory = mod.make_factories(form)["resnet20"]
    return (lambda r: factory(rngs=r)) if package == "jax" else \
        (lambda g: factory(generator=g))


def zoo_twins(kind, form, seed=0, rho=None):
    """(jax model, torch model): one model of the zoo in both packages,
    eval mode, holding the same ``zoo_state`` weights. The JAX model is
    built with ``nnx.eval_shape`` and then given the weights, its noise
    keys and its scalar priors (mean 0, sigma 1)."""
    jm = nnx.eval_shape(lambda: _model(kind, form, "jax")(
        nnx.Rngs(params=seed, noise=seed + 1)))
    state = nnx.state(jm)
    flat = [(_torch_key_for(path), v) for path, v in
            nnx.to_flat_state(state)]
    arrays = zoo_state(
        {key: np.zeros(v.get_value().shape, np.float32) for key, v in flat
         if isinstance(v, (nnx.Param, nnx.BatchStat))}, seed=seed, rho=rho)
    for key, v in flat:
        if key in arrays:
            v.set_value(jnp.asarray(arrays[key]))
        elif isinstance(v, nnx.RngKey):
            v.set_value(jax.random.key(seed))
        elif isinstance(v, nnx.RngCount):
            v.set_value(jnp.zeros(v.get_value().shape, jnp.uint32))
        else:  # the scalar priors
            v.set_value(jnp.float32(1.0 if key.endswith("sigma") else 0.0))
    nnx.update(jm, state)
    set_jax_eval(jm)
    tm = _model(kind, form, "torch")(torch.Generator().manual_seed(seed))
    load_jax_state(tm, arrays)
    tm.eval()
    return jm, tm


def _input(kind, batch=2, seed=1):
    return _x((batch, 1, 28, 28) if kind == "scnn" else (batch, 3, 16, 16),
              seed)


def _close(got, want, scale=None):
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(to_np(got), want, rtol=1e-4,
                               atol=1e-4 * scale)


def inject_flipout(monkeypatch, jm, tm, x, seed):
    """Every Flipout layer of both models takes its eps and its signs from
    numpy, matched by module name; the signs' shapes come from a
    recording forward of the torch model. Returns the noise by name, which
    the torch model reads at each call (edit it to change its draw)."""
    layers = set(iter_bayesian_layers(tm))
    layers = {name: m for name, m in tm.named_modules() if m in layers}
    shapes = {}
    handles = [m.register_forward_hook(
        lambda mod, inp, out, _n=name: shapes.__setitem__(
            _n, (inp[0].shape, out[0].shape)))
        for name, m in layers.items()]
    with torch.no_grad():
        tm(torch.from_numpy(x))
    for h in handles:
        h.remove()
    rs = np.random.RandomState(seed)

    def signs(shape):
        return (rs.randint(0, 2, tuple(shape)) * 2 - 1).astype(np.float32)

    noise = {}
    for name, m in layers.items():
        conv = hasattr(m, "mu_kernel")
        mu = m.mu_kernel if conv else m.mu_weight
        e = {"eps_k" if conv else "eps_w": _x(mu.shape, rs.randint(2**31))}
        if m.mu_bias is not None:
            e["eps_b"] = _x(m.mu_bias.shape, rs.randint(2**31))
        e["sign_in"], e["sign_out"] = map(signs, shapes[name])
        noise[name] = e
        m.register_forward_pre_hook(
            lambda mod, args, kw, _n=name: (args, {**kw, **{
                k: torch.from_numpy(v) for k, v in noise[_n].items()}}),
            with_kwargs=True)
    by_id = {id(m): _torch_key_for(path)
             for path, m in nnx.iter_modules(jm)
             if _torch_key_for(path) in noise}
    classes = {type(m) for _, m in nnx.iter_modules(jm) if id(m) in by_id}
    for cls in classes:
        def call(self, x, *args, _call=cls.__call__, **kw):
            if id(self) in by_id:
                kw.update({k: jnp.asarray(v)
                           for k, v in noise[by_id[id(self)]].items()})
            return _call(self, x, *args, **kw)
        monkeypatch.setattr(cls, "__call__", call)
    assert len(by_id) == len(noise)
    return noise


@pytest.mark.parametrize("form", FORMS, ids=["det", "reparam", "flipout"])
@pytest.mark.parametrize("kind", ["scnn", "resnet20"])
def test_zoo_matches_jax(monkeypatch, kind, form):
    jm, tm = zoo_twins(kind, form, seed=3)
    x = _input(kind)
    if form == FLIPOUT:
        noise = inject_flipout(monkeypatch, jm, tm, x, seed=4)
    if form != REPARAM:
        want = jm(jnp.asarray(x))
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        if form is None:
            _close(got, want)
            return
        _close(got[0], want[0])
        assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-5)
        want, got_kl = jax_get_kl_loss(jm), get_kl_loss(tm).detach()
        assert float(got_kl) == pytest.approx(float(want), rel=1e-5)
        # the perturbation reaches the logits: with every eps 0 they move
        for e in noise.values():
            for k in e:
                if k.startswith("eps"):
                    e[k] = np.zeros_like(e[k])
        with torch.no_grad():
            mean = tm(torch.from_numpy(x))[0]
        assert (got[0] - mean).abs().max() > 1e-2 * mean.abs().max()
        return
    inject_draws(monkeypatch, draw_noise(tm, S, seed=4))
    want, want_kl = jmc.mc_forward(jm, jnp.asarray(x), S, presample="on",
                                   emission="vmap")
    assert np.abs(np.asarray(want[0] - want[1])).max() > 1e-3
    for emission in ("scan", "vmap"):
        got, kl = tmc.mc_forward(tm, torch.from_numpy(x), S,
                                 presample="on", emission=emission)
        assert got.shape == (S, 2, 10)
        _close(got, want)
        assert float(kl) == pytest.approx(float(want_kl), rel=1e-5)


@pytest.mark.parametrize("form", [REPARAM, FLIPOUT])
@pytest.mark.parametrize("kind", ["scnn", "resnet20"])
def test_draw_axis_equals_the_loop_lane_for_lane(kind, form):
    """presample "on" with the generators rewound: both emissions take the
    same draws (and Flipout signs), so lane s of the vmap emission is the
    loop's draw s. A pad of the whole S*C channel axis would break the
    residual add; a log_softmax over all S*10 outputs would leave lanes
    whose probabilities sum to 1/S."""
    _, tm = zoo_twins(kind, form, seed=5)
    x = torch.from_numpy(_input(kind, seed=6))
    gens = [m.generator for m in iter_bayesian_layers(tm)]
    states = [g.get_state() for g in gens]
    loop = tmc.mc_forward(tm, x, 3, presample="on", return_kl=False)
    for g, st in zip(gens, states):
        g.set_state(st)
    vmap = tmc.mc_forward(tm, x, 3, presample="on", emission="vmap",
                          return_kl=False)
    assert vmap.shape == loop.shape == (3, 2, 10)
    _close(vmap, loop.numpy())
    assert not torch.allclose(loop[0], loop[1], atol=1e-4)
    if kind == "scnn":
        torch.testing.assert_close(vmap.exp().sum(-1), torch.ones(3, 2),
                                   rtol=1e-5, atol=1e-5)


def test_cifar_resnet_vmap_training_step_matches_the_loop(monkeypatch):
    """One ELBO step on the same injected draws (presample "on"), the
    draw loop against the vmap emission: loss, every gradient and the BN
    running statistics after their one EMA update."""
    _, tm = zoo_twins("resnet20", REPARAM, seed=7)
    tm.train()
    inject_draws(monkeypatch, draw_noise(tm, 3, seed=8))
    twin = copy.deepcopy(tm)
    x = torch.from_numpy(_input("resnet20", batch=4, seed=9))
    y = torch.from_numpy(np.random.RandomState(10).randint(0, 10, 4))
    results = []
    for model, emission in ((tm, "scan"), (twin, "vmap")):
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        loss, _, _ = engine.make_train_step(
            3, 4, presample="on", emission=emission)(model, opt, x, y)
        results.append((loss, {n: p.grad for n, p in
                               model.named_parameters()},
                        model.state_dict()))
    (loss_a, grads_a, state_a), (loss_b, grads_b, state_b) = results
    assert float(loss_b) == pytest.approx(float(loss_a), rel=1e-5)
    for name, g in grads_a.items():
        assert bool((g != 0).any()), name
        torch.testing.assert_close(grads_b[name], g, rtol=1e-4, atol=1e-4,
                                   msg=name)
    for name, v in state_a.items():
        torch.testing.assert_close(state_b[name], v, rtol=1e-4, atol=1e-4,
                                   msg=name)


def test_option_a_shortcut_matches_jax_on_floats_and_qtensors():
    rs = np.random.RandomState(11)
    x = rs.randn(2, 8, 6, 6).astype(np.float32)
    got = tcifar._option_a_shortcut(torch.from_numpy(x), 16)
    want = jcifar._option_a_shortcut(jnp.asarray(x), 16)
    assert got.shape == (2, 16, 3, 3)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    q = rs.randint(0, 256, (2, 8, 6, 6)).astype(np.uint8)
    got = tcifar._option_a_shortcut(QTensor(torch.from_numpy(q), 0.05, 117),
                                    16)
    want = jcifar._option_a_shortcut(jF.QTensor(jnp.asarray(q), 0.05, 117),
                                     16)
    assert isinstance(got, QTensor) and (got.scale, got.zp) == (0.05, 117)
    assert got.q.dtype == torch.uint8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    # under the draw axis each draw's block is padded on its own
    draws = torch.from_numpy(rs.randn(2, 3 * 8, 6, 6).astype(np.float32))
    got = tcifar._option_a_shortcut(draws, 16, num_draws=3)
    assert got.shape == (2, 3 * 16, 3, 3)
    for s in range(3):
        torch.testing.assert_close(
            got[:, 16 * s:16 * (s + 1)],
            tcifar._option_a_shortcut(draws[:, 8 * s:8 * (s + 1)], 16),
            rtol=0, atol=0)


def test_dropout2d_drops_whole_channels_from_its_generator():
    x = torch.ones(4, 6, 5, 5)
    drop = Dropout2d(0.5, generator=torch.Generator().manual_seed(0))
    out = drop(x)
    per_channel = out.reshape(4, 6, -1)
    assert bool(((per_channel == 0).all(-1) | (per_channel == 2).all(-1))
                .all())
    assert 0 < int((per_channel[..., 0] == 0).sum()) < 24
    again = Dropout2d(0.5, generator=torch.Generator().manual_seed(0))(x)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    flat = Dropout2d(0.5, generator=torch.Generator().manual_seed(1))(
        torch.ones(64, 128))
    # an (N, C) input drops element by element, as the JAX Dropout2d does
    assert 0 < int((flat == 0).sum(1).min()) and int(
        (flat == 0).sum(1).max()) < 128
    drop.eval()
    assert drop(x) is x


def test_cifar_resnet_int8_flow_matches_jax():
    """prepare -> calibrate (2 batches) -> convert with conv+BN folding and
    uint8 activations, in both packages: the port's ``quantize()`` gives
    JAX's int8 state, and with JAX's quant_dicts and frozen draws carried
    across, the logits agree. The tolerance of
    ``test_torch_port_quant.py::test_prepare_calibrate_convert_matches_jax``:
    3 head quanta, at least 90 % of the logits equal."""
    from bayesian_torch_tpu.quantization import (
        convert as jconvert, freeze_quantized_draws as jfreeze,
        prepare as jprepare)
    from bayesian_torch_tpu_torch.quantization import convert, prepare
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_quant_state
    from tests.test_torch_port_quant import (_assert_quant_state_close,
                                             _jax_quant_state)

    jm, tm = zoo_twins("resnet20", REPARAM, seed=12)
    jprepare(jm), prepare(tm)
    for i in range(2):
        jm(jnp.asarray(_input("resnet20", seed=20 + i)))
    jconvert(jm, fuse_conv_bn=True, quantize_activations=True)
    convert(tm, fuse_conv_bn=True, quantize_activations=True)
    arrays, _ = _jax_quant_state(jm)
    state = tm.state_dict()
    assert set(state) == set(arrays)
    _assert_quant_state_close(state, arrays)
    jfreeze(jm)
    arrays, quant_dicts = _jax_quant_state(jm)
    load_jax_quant_state(tm, arrays, quant_dicts)
    x = _input("resnet20", seed=30)
    want = np.asarray(jm(jnp.asarray(x))[0])
    got, kl = tm(torch.from_numpy(x))
    assert got.shape == (2, 10) and float(kl) == 0.0
    assert np.abs(want).max() > 0.1  # a signal, not all zeros
    head_q = tm.linear.quant_dict[4]["scale"]
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 3 * head_q * (1 + 1e-6), diff.max() / head_q
    assert (diff == 0).mean() >= 0.9


@pytest.mark.parametrize("form", FORMS, ids=["det", "reparam", "flipout"])
def test_every_depth_and_the_resnet110_weight_count(form):
    """Every factory builds its depth (3 stages of n = (depth - 2) / 6
    blocks), under the JAX module's names; the Bayesian ResNet-110 holds
    111 weight tensors that draw noise: 109 convs (no bias) and the
    head's weight and bias."""
    from bayesian_torch_tpu.models.bayesian import resnet_variational as jrv
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_flipout, resnet_variational)
    from bayesian_torch_tpu_torch.models.deterministic import resnet
    from bayesian_torch_tpu_torch.models.flipout import resnet as fresnet

    zoo = {None: resnet, REPARAM: resnet_variational,
           FLIPOUT: resnet_flipout}[form]
    assert zoo.__all__ == jrv.__all__
    assert fresnet.resnet20 is resnet_flipout.resnet20
    for name in zoo.__all__:
        depth = int(name[len("resnet"):])
        model = getattr(zoo, name)(generator=torch.Generator().manual_seed(0),
                                   device="meta")
        assert [len(layer) for layer in (model.layer1, model.layer2,
                                         model.layer3)] == \
            [(depth - 2) // 6] * 3
    layers = list(iter_bayesian_layers(model))  # the ResNet-110
    if form is None:
        assert not layers
        return
    assert len(layers) == 110
    assert sum(1 + (m.mu_bias is not None) for m in layers) == 111


@pytest.mark.parametrize("kind,form,num_mc", [
    ("resnet20", REPARAM, 1), ("resnet20", REPARAM, 4),
    ("resnet20", FLIPOUT, 1), ("scnn", REPARAM, 1), ("scnn", REPARAM, 4)])
def test_chip_smoke_launch_counts_match_a_step(monkeypatch, kind, form,
                                               num_mc):
    """``chip_smoke.py`` gates the zoo's steps on the card by the launches
    of ``expected_step_launches`` (MC-1, the draw loop) and
    ``expected_vmap_launches`` (MC-4, emission "auto": vmap). Here the
    plain versions stand in for the kernels and bump their counters, and
    one ELBO step of the zoo's model on the CPU launches just those."""
    import chip_smoke as cs
    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka

    for name, counter in (
            ("sample_scaled_normals_batch_plain",
             ka.sample_scaled_normals_batch),
            ("dsigma_plain", ka.dsigma), ("drho_plain", ka.drho)):
        def counted(*args, _fn=getattr(ka, name), _counter=counter, **kw):
            _counter.launches += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(ka, name, counted)
    tm = _model(kind, form, "torch")(torch.Generator().manual_seed(9)).train()
    x = torch.from_numpy(_input(kind, seed=10))
    y = torch.tensor([3, 7])
    want = (cs.expected_step_launches(tm, 1) if num_mc == 1
            else cs.expected_vmap_launches(tm, training=True))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    cs.reset_counts()
    loss, _, _ = engine.make_train_step(num_mc, 2)(tm, opt, x, y)
    assert math.isfinite(float(loss))
    assert cs.counts() == want
    assert want["K-A"] > 0 and want["K-C drho" if num_mc == 1
                                    else "K-C dsigma"] == want["K-A"]
