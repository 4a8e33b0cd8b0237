"""Channels-last (``data_format="NHWC"``) models in the port against the
JAX package's, on the CPU (the ops and layers: ``test_torch_port_nhwc.py``).

The narrow ResNet of ``tests/_torch_port.py`` built NHWC in both packages
with the same weights (``load_jax_state``) and the same injected per-draw
weights (``inject_draws``): ``mc_forward`` through the loop, the vmap
emission and ``structured=True`` against JAX's vmap emission; at rho = -25
against JAX's structured mode; the NHWC model against the NCHW one; an
MC-4 ELBO step against JAX's (the JAX halves compiled with ``nnx.jit``).
``dnn_to_bnn`` of an NHWC deterministic model, the deterministic NHWC
convs, and ``qresnet18`` converted NHWC against its NCHW twin bit for bit.
Tolerance 1e-4 x max|out| (f32), bit for bit for INT8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from torch import nn

import bayesian_torch_tpu.nn as jdnn
import bayesian_torch_tpu_torch.nn as tdnn
from bayesian_torch_tpu.parallel import mc as jmc
from bayesian_torch_tpu.utils.checkpoint import (_torch_key_for,
                                                 import_torch_state_dict)
from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
from tests._torch_port import (draw_noise, inject_draws, jax_arrays,
                               random_state, set_jax_eval, tiny_twins, to_np)
from tests.test_torch_port_nhwc import _close, _j, _last, _t

# --- the narrow NHWC ResNet under mc_forward ---------------------------------

S, B = 3, 2


def _x_nhwc(seed, hw=8):
    x = np.random.RandomState(seed).randn(B, 3, hw, hw).astype(np.float32)
    return x, _last(x)


@pytest.mark.parametrize("emission", ["scan", "vmap", "structured"])
def test_mc_forward_nhwc_matches_jax(monkeypatch, emission):
    """The same injected per-draw weights in both packages: the port's
    loop, vmap and ``structured=True`` against JAX's vmap emission, (S, B,
    10) each."""
    jm, tm, _ = tiny_twins(seed=21, data_format="NHWC")
    inject_draws(monkeypatch, draw_noise(tm, S))
    _, xl = _x_nhwc(22)
    want = nnx.jit(lambda m, x: jmc.mc_forward(
        m, x, S, presample="on", emission="vmap", return_kl=False))(
            jm, _j(xl))
    kw = (dict(structured=True) if emission == "structured"
          else dict(emission=emission))
    got = tmc.mc_forward(tm, _t(xl), S, presample="on", return_kl=False,
                         **kw)
    assert got.shape == (S, B, 10)
    _close(got, want)


def test_structured_nhwc_matches_jax_structured_and_the_vmap_emission():
    """At rho = -25 every draw is the mean forward in both packages, so
    JAX's structured mode (its own noise streams) and the port's agree
    draw for draw; the port's ``structured=True`` is its vmap emission bit
    for bit on the same generator state."""
    from bayesian_torch_tpu.parallel import mc_forward as jmc_forward
    from bayesian_torch_tpu_torch.ops.sampling import module_generators

    jm, tm, _ = tiny_twins(seed=23, rho=-25.0, data_format="NHWC")
    _, xl = _x_nhwc(24)
    want = nnx.jit(lambda m, x: jmc_forward(m, x, S, return_kl=False,
                                            structured=True))(jm, _j(xl))
    gens = module_generators(tm)
    state = [g.get_state() for g in gens]
    got = tmc.mc_forward(tm, _t(xl), S, return_kl=False, structured=True)
    _close(got, want)
    for g, st in zip(gens, state):
        g.set_state(st)
    vmap = tmc.mc_forward(tm, _t(xl), S, return_kl=False, emission="vmap")
    assert torch.equal(got, vmap)


@pytest.mark.parametrize("emission", ["scan", "vmap"])
def test_reparameterization_nhwc_is_nchw_permuted(monkeypatch, emission):
    """Same weights, same draws: the NHWC model's logits are the NCHW
    model's (the layout changes no value of a reparameterization draw),
    and a conv layer's NHWC output is its NCHW output permuted."""
    _, t_last, arrays = tiny_twins(seed=25, data_format="NHWC")
    _, t_first, _ = tiny_twins(seed=25)
    noise = draw_noise(t_last, S)
    inject_draws(monkeypatch, noise)
    x, xl = _x_nhwc(26)
    got = tmc.mc_forward(t_last, _t(xl), S, presample="on",
                         emission=emission, return_kl=False)
    want = tmc.mc_forward(t_first, _t(x), S, presample="on",
                          emission=emission, return_kl=False)
    _close(got, to_np(want), rel=1e-5)
    eps = torch.from_numpy(noise["conv1"]["w"][0])
    a = t_last.conv1(_t(xl), eps_k=eps)[0]
    b = t_first.conv1(_t(x), eps_k=eps)[0]
    torch.testing.assert_close(a, b.permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-5)


def _jax_elbo_step(jm, x, y, num_mc, lr):
    def loss_fn(model):
        outs, kl = jmc.mc_forward(model, x, num_mc, presample="on",
                                  emission="vmap")
        log_probs = jax.nn.log_softmax(outs, axis=-1)
        nll = -jnp.take_along_axis(log_probs.mean(axis=0), y[:, None],
                                   axis=1).mean()
        return nll + kl / x.shape[0]

    # compiled: op-by-op dispatch of the vmapped gradient takes minutes
    loss, grads = nnx.jit(nnx.value_and_grad(loss_fn))(jm)
    opt = nnx.Optimizer(jm, optax.sgd(lr, 0.9), wrt=nnx.Param)
    opt.update(jm, grads)
    return float(loss), {_torch_key_for(p): np.asarray(v[...])
                         for p, v in nnx.to_flat_state(grads)}


@pytest.mark.parametrize("emission", ["scan", "vmap"])
def test_elbo_step_nhwc_matches_jax(monkeypatch, emission):
    """An MC-4 ELBO step of the NHWC narrow ResNet (SGD 0.05, momentum
    0.9) through the port's loop and vmap emission against JAX's vmap step
    on the same injected draws: loss, gradients, the updated parameters
    and BatchNorm statistics."""
    num_mc, lr = 4, 0.05
    jm, tm, _ = tiny_twins(seed=27, data_format="NHWC")
    set_jax_eval(jm, training=True)
    tm.train()
    inject_draws(monkeypatch, draw_noise(tm, num_mc))
    _, xl = _x_nhwc(28)
    y = np.array([1, 7])
    want_loss, want_grads = _jax_elbo_step(jm, _j(xl), _j(y), num_mc, lr)
    step = engine.make_train_step(num_mc, B, presample="on",
                                  emission=emission)
    opt = torch.optim.SGD(tm.parameters(), lr=lr, momentum=0.9)
    loss, _, _ = step(tm, opt, _t(xl), torch.from_numpy(y))
    assert float(loss) == pytest.approx(want_loss, rel=1e-4, abs=1e-4)
    for name, p in tm.named_parameters():
        _close(p.grad, want_grads[name], rel=1e-4)
    after = jax_arrays(jm)
    for name, v in tm.state_dict().items():
        _close(v.float(), after[name].astype(np.float32), rel=1e-4)


# --- model surgery -----------------------------------------------------------


def test_dnn_to_bnn_of_an_nhwc_deterministic_model():
    """The twins take their deterministic convs' ``data_format`` (JAX
    ``dnn_to_bnn``); with JAX's converted state carried across and rho =
    -30 both converted models give the same NHWC logits."""
    from bayesian_torch_tpu.models.dnn_to_bnn import dnn_to_bnn as jdnn2bnn
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import dnn_to_bnn

    params = {"prior_mu": 0.0, "prior_sigma": 1.0, "posterior_mu_init": 0.0,
              "posterior_rho_init": -3.0, "type": "Reparameterization",
              "moped_enable": False, "moped_delta": 0.5}
    r = nnx.Rngs(0)
    jm = jdnn.Sequential(jdnn.Conv2d(3, 8, 3, padding=1, rngs=r,
                                     data_format="NHWC"),
                         jdnn.BatchNorm2d(8, data_format="NHWC"),
                         jdnn.Conv2d(8, 6, 1, rngs=r, data_format="NHWC"))
    tm = tdnn.Sequential(tdnn.Conv2d(3, 8, 3, padding=1, data_format="NHWC"),
                         tdnn.BatchNorm2d(8, data_format="NHWC"),
                         tdnn.Conv2d(8, 6, 1, data_format="NHWC"))
    set_jax_eval(jm)
    tm.eval()
    jdnn2bnn(jm, params)
    dnn_to_bnn(tm, params)
    assert type(tm[0]).__name__ == "Conv2dReparameterization"
    assert tm[0].data_format == tm[2].data_format == "NHWC"
    arrays = random_state(jax_arrays(jm), seed=5, rho=-30.0)
    import_torch_state_dict(jm, arrays)
    load_jax_state(tm, arrays)
    _, xl = _x_nhwc(29)
    _close(tm(_t(xl)), jm(_j(xl)))


def test_deterministic_nhwc_convs_match_jax(monkeypatch):
    """The port's ``nn.Conv2d`` / ``ConvTranspose2d`` with ``data_format``:
    torch's own forward under NCHW, JAX's under NHWC (its 1x1 stride-1
    conv through the pointwise emission, ``pointwise_dot = True`` as in
    JAX: K-G channels-last's plain version here)."""
    calls = []
    real = kg._apply_cl
    monkeypatch.setattr(kg, "_apply_cl",
                        lambda *a: calls.append(a[4]) or real(*a))
    for cls, args in ((tdnn.Conv2d, (4, 6, 1)), (tdnn.Conv2d, (4, 6, 3)),
                      (tdnn.ConvTranspose2d, (4, 6, 3))):
        tm = cls(*args, stride=1, data_format="NHWC")
        jm = getattr(jdnn, cls.__name__)(*args, stride=1, rngs=nnx.Rngs(0),
                                         data_format="NHWC")
        arrays = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
        import_torch_state_dict(jm, arrays)
        x = np.random.RandomState(1).randn(2, 5, 5, 4).astype(np.float32)
        got = tm(_t(x))
        _close(got, jm(_j(x)), rel=1e-5)
        first = getattr(nn, cls.__name__)(*args, stride=1)
        first.load_state_dict(tm.state_dict())
        _close(got, to_np(first(_t(np.moveaxis(x, -1, 1))).movedim(1, -1)),
               rel=1e-5)
    assert calls == [kg.pointwise_gemm_cl]


@pytest.mark.parametrize("estimator", ["Reparameterization", "Flipout"])
def test_converted_nhwc_resnet_is_the_nchw_resnet(estimator):
    """``qresnet18`` (calibrated, ``fuse_conv_bn=True``, uint8
    activations) built NHWC keeps NHWC in every quantized conv, pool and
    BatchNorm, and with the same state, quant_dicts and frozen draws its
    logits equal the NCHW model's bit for bit: the same integer and f32
    operations on the same (B, *sp, C) memory. Flipout at rho = -30 (its
    signs are hashed in each layout's own flat order, so only a vanishing
    perturbation makes the two comparable)."""
    from bayesian_torch_tpu_torch.models.bayesian import (
        quantized_resnet_flipout_large as qflip,
        quantized_resnet_variational_large as qrep)
    from bayesian_torch_tpu_torch.quantization import freeze_quantized_draws

    factory = (qflip if estimator == "Flipout" else qrep).qresnet18
    x, xl = _x_nhwc(32, hw=32)

    def build(df, image):
        def calibrate(model):
            for mod in model.modules():
                if hasattr(mod, "rho_kernel") and estimator == "Flipout":
                    with torch.no_grad():
                        mod.rho_kernel.fill_(-30.0)
            model(image)

        return factory(num_classes=10, data_format=df, fuse_conv_bn=True,
                       calibrate=calibrate,
                       generator=torch.Generator().manual_seed(31))

    last, first = build("NHWC", _t(xl)), build("NCHW", _t(x))
    formats = {m.data_format for m in last.modules()
               if hasattr(m, "data_format")}
    assert formats == {"NHWC"}
    first.load_state_dict(last.state_dict())
    for a, b in zip(last.modules(), first.modules()):
        if getattr(a, "quant_dict", None) is not None:
            b.quant_dict = a.quant_dict
    for m in (last, first):
        for mod in m.modules():
            if isinstance(getattr(mod, "generator", None), torch.Generator):
                mod.generator.manual_seed(5)
        freeze_quantized_draws(m)
    got, want = last(_t(xl))[0], first(_t(x))[0]
    assert got.shape == (B, 10) and bool((got != 0).any())
    assert torch.equal(got, want)


# --- the mesh paths refuse NHWC ----------------------------------------------
