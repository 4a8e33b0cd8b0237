"""The port's model-surgery slice against the JAX package, on the CPU:
the deterministic ResNet zoo, ``dnn_to_bnn`` (with MOPED), ``get_rho``,
``MOPED``, ``freeze_batchnorm``, the four ImageNet trainers that use them
and ``graft_entry.entry``.

Inputs are numpy arrays from fixed seeds, handed to both packages.
Tolerances: forwards and losses 1e-4 (absolute and relative, outputs of
order 1 summed in another order by another library), posteriors and
priors copied or mapped elementwise 1e-6, KL 1e-6 relative.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch import nn

import bayesian_torch_tpu.nn as jdnn
from bayesian_torch_tpu.models import _large_resnet as jres
from bayesian_torch_tpu.models import dnn_to_bnn as jax_dnn_to_bnn
from bayesian_torch_tpu.models import get_kl_loss as jax_get_kl_loss
from bayesian_torch_tpu.parallel import mc as jmc
from bayesian_torch_tpu.utils import util as jutil
from bayesian_torch_tpu.utils.checkpoint import (_torch_key_for,
                                                 import_torch_state_dict)
from bayesian_torch_tpu_torch import layers as tl
from bayesian_torch_tpu_torch.models import _large_resnet as tres
from bayesian_torch_tpu_torch.models import dnn_to_bnn, get_kl_loss
from bayesian_torch_tpu_torch.models.deterministic import resnet_large as tdet
from bayesian_torch_tpu_torch.nn import BatchNorm2d, Sequential
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.utils import MOPED, freeze_batchnorm, get_rho
from bayesian_torch_tpu_torch.utils.checkpoint import (load_jax_state,
                                                       save_checkpoint)
from tests._torch_port import (REPARAM, draw_noise, inject_draws, jax_arrays,
                               random_state, set_jax_eval, to_np)

TOL = dict(rtol=1e-4, atol=1e-4)
EXACT = dict(rtol=1e-6, atol=1e-7)
PRIORS = {"prior_mu": 0.0, "prior_sigma": 1.0, "posterior_mu_init": 0.0,
          "posterior_rho_init": -3.0, "type": REPARAM,
          "moped_enable": False, "moped_delta": 0.5}


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def det_state(arrays, seed=0):
    """Random weights for a deterministic model: conv and linear weights
    N(0, sqrt(2 / fan_in)) (activations of order 1 through the depth),
    everything else as ``random_state``."""
    out = random_state(arrays, seed=seed)
    rs = np.random.RandomState(seed + 100)
    for key, a in arrays.items():
        shape = np.shape(a)
        if key.endswith(".weight") and len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            out[key] = rs.normal(0, math.sqrt(2.0 / fan_in),
                                 shape).astype(np.float32)
    return out


def det_twins(jax_factory, torch_factory, seed=0):
    """(jax model, torch model, arrays): one deterministic model in both
    packages holding the same ``det_state`` weights, in eval mode. The
    JAX model is built abstractly (``nnx.eval_shape``; its eager random
    init would compile once per shape, about 20 s for a ResNet-18) and
    then given the weights."""
    jm = nnx.eval_shape(lambda: jax_factory(
        nnx.Rngs(params=seed, noise=seed + 1)))
    state = nnx.state(jm, nnx.Any(nnx.Param, nnx.BatchStat))
    flat = [(_torch_key_for(path), v)
            for path, v in nnx.to_flat_state(state)]
    arrays = det_state({key: np.broadcast_to(np.float32(0),
                                             v.get_value().shape)
                        for key, v in flat}, seed=seed)
    for key, v in flat:
        v.set_value(jnp.asarray(arrays[key]))
    nnx.update(jm, state)
    set_jax_eval(jm)
    tm = torch_factory(torch.Generator().manual_seed(seed))
    load_jax_state(tm, arrays)
    tm.eval()
    return jm, tm, arrays


def resnet18_twins(seed=0, num_classes=10):
    from bayesian_torch_tpu.models.deterministic.resnet_large import (
        resnet18 as jax_resnet18,
    )
    return det_twins(
        lambda rngs: jax_resnet18(num_classes=num_classes, rngs=rngs),
        lambda g: tdet.resnet18(num_classes=num_classes, generator=g), seed)


# --- a narrow deterministic ResNet: stem, two Bottlenecks, head ---


class JaxDetTiny(nnx.Module):
    def __init__(self, rngs):
        self.conv1 = jdnn.Conv2d(3, 16, 3, padding=1, bias=False, rngs=rngs)
        self.bn1 = jdnn.BatchNorm2d(16)
        down = jdnn.Sequential(
            jdnn.Conv2d(16, 32, 1, stride=2, bias=False, rngs=rngs),
            jdnn.BatchNorm2d(32))
        self.layer1 = jdnn.Sequential(
            jres.Bottleneck(16, 8, 2, down, estimator=None, rngs=rngs),
            jres.Bottleneck(32, 8, estimator=None, rngs=rngs))
        self.fc = jdnn.Linear(32, 10, rngs=rngs)

    def __call__(self, x):
        out = jax.nn.relu(self.bn1(self.conv1(x)))
        for block in self.layer1:
            out = block(out)
        return self.fc(out.mean(axis=(2, 3)))


class TorchDetTiny(nn.Module):
    def __init__(self, generator=None):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(16)
        down = Sequential(nn.Conv2d(16, 32, 1, stride=2, bias=False),
                          BatchNorm2d(32))
        self.layer1 = nn.Sequential(
            tres.Bottleneck(16, 8, 2, down, estimator=None,
                            generator=generator),
            tres.Bottleneck(32, 8, estimator=None, generator=generator))
        self.fc = nn.Linear(32, 10)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        for block in self.layer1:
            out = block(out)
        return self.fc(out.mean(dim=(2, 3)))


def converted_tiny_twins(seed=0):
    """(jax, torch, arrays): the narrow deterministic ResNet on shared
    weights, converted by each package's ``dnn_to_bnn``, then given the
    same random posteriors and BN state."""
    jm, tm, _ = det_twins(JaxDetTiny, TorchDetTiny, seed)
    jax_dnn_to_bnn(jm, PRIORS)
    dnn_to_bnn(tm, PRIORS)
    arrays = random_state(jax_arrays(jm), seed=seed + 1)
    import_torch_state_dict(jm, arrays)
    load_jax_state(tm, arrays)
    return jm, tm, arrays


def _jax_layers_by_name(model):
    """{torch-style module name: Bayesian layer} of an nnx model."""
    from bayesian_torch_tpu.models.dnn_to_bnn import iter_bayesian_layers

    layers = set(map(id, iter_bayesian_layers(model)))
    return {_torch_key_for(path): mod
            for path, mod in nnx.iter_modules(model) if id(mod) in layers}


# --- the deterministic zoo ---------------------------------------------------


@pytest.mark.parametrize("training", [False, True])
def test_deterministic_resnet18_matches_jax(training):
    """Eval and train mode (batch statistics, then the same running
    statistics); 64x64 at batch 4, so layer4's batch statistics are taken
    over 16 values and not 2."""
    jm, tm, _ = resnet18_twins(seed=1)
    set_jax_eval(jm, training=training)
    tm.train(training)
    x = _x((4, 3, 64, 64), seed=2)
    want = jm(jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.shape == (4, 10)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    # train mode: the same running statistics after the batch
    after = jax_arrays(jm)
    for key, v in tm.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(to_np(v), after[key], **TOL,
                                       err_msg=key)


@pytest.mark.parametrize("training", [False, True])
def test_deterministic_bottleneck_with_downsample_matches_jax(training):
    def jax_block(rngs):
        down = jdnn.Sequential(
            jdnn.Conv2d(8, 32, 1, stride=2, bias=False, rngs=rngs),
            jdnn.BatchNorm2d(32))
        return jres.Bottleneck(8, 8, 2, down, estimator=None, rngs=rngs)

    def torch_block(g):
        down = Sequential(nn.Conv2d(8, 32, 1, stride=2, bias=False),
                          BatchNorm2d(32))
        return tres.Bottleneck(8, 8, 2, down, estimator=None, generator=g)

    jb, tb, _ = det_twins(jax_block, torch_block, seed=3)
    set_jax_eval(jb, training=training)
    tb.train(training)
    x = _x((2, 8, 8, 8), seed=4)
    got = tb(torch.from_numpy(x))
    assert got.shape == (2, 32, 4, 4)
    np.testing.assert_allclose(to_np(got), np.asarray(jb(jnp.asarray(x))),
                               **TOL)


def _torchvision_manifest():
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "torchvision_resnet50_keys.txt")
    manifest = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                key, shp = line.split()
                manifest[key] = (() if shp == "-"
                                 else tuple(int(s) for s in shp.split(",")))
    return manifest


def test_deterministic_resnet50_has_the_torchvision_keys():
    """Exactly torchvision's 320 keys and shapes, so a deterministic JAX
    ResNet-50's state (or a torchvision file) loads strictly."""
    manifest = _torchvision_manifest()
    assert len(manifest) == 320
    model = tdet.resnet50(generator=torch.Generator().manual_seed(0))
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == manifest
    rs = np.random.RandomState(0)
    arrays = {k: (np.asarray(7, np.int32) if k.endswith("tracked")
                  else rs.randn(*shape).astype(np.float32))
              for k, shape in manifest.items()}
    assert load_jax_state(model, arrays) == ([], [])
    assert int(model.bn1.num_batches_tracked) == 7
    assert model.bn1.num_batches_tracked.dtype == torch.int64


def test_deterministic_zoo_init_device_and_refusals():
    a = tdet.resnet18(generator=torch.Generator().manual_seed(5))
    b = tdet.resnet18(generator=torch.Generator().manual_seed(5))
    for (key, va), vb in zip(a.state_dict().items(),
                             b.state_dict().values()):
        assert torch.equal(va, vb), key  # all from the model's generator
    w = a.layer1[0].conv1.weight
    assert abs(w.std().item() - math.sqrt(2.0 / (9 * 64))) < 0.01
    assert torch.equal(a.bn1.weight, torch.ones(64))
    assert torch.equal(a.bn1.bias, torch.zeros(64))
    assert type(a.layer2[0].downsample[1]) is BatchNorm2d
    assert all(type(m) in (nn.Conv2d, nn.Linear) for m in a.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear)))
    assert a.conv1.bias is None and a.fc.bias is not None
    assert tdet.resnet34(device="meta").fc.weight.device.type == "meta"
    with pytest.raises(NotImplementedError):
        tdet.resnet50(pretrained=True)


@pytest.mark.parametrize("delta", [1e-4, 0.1, 0.5])
def test_get_rho_matches_jax(delta):
    w = np.random.RandomState(0).normal(0, 0.05, (64, 3, 3, 3)).astype(
        np.float32)
    got = get_rho(torch.from_numpy(w), delta)
    want = np.asarray(jutil.get_rho(jnp.asarray(w), delta))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # softplus(rho) = delta * |w|
    np.testing.assert_allclose(torch.nn.functional.softplus(got).numpy(),
                               delta * np.abs(w), rtol=1e-5)


# --- dnn_to_bnn ---------------------------------------------------------------

SMALL = [  # (name, torch class, JAX class, constructor arguments)
    ("c1", nn.Conv1d, jdnn.Conv1d, (4, 6, 3), dict(stride=2, padding=1)),
    ("c2", nn.Conv2d, jdnn.Conv2d, (4, 8, 3),
     dict(padding=2, dilation=2, groups=2, bias=False)),
    ("c2s", nn.Conv2d, jdnn.Conv2d, (4, 4, 3), dict(padding="same")),
    ("c3", nn.Conv3d, jdnn.Conv3d, (2, 4, (1, 3, 3)),
     dict(stride=(1, 2, 2), bias=False)),
    ("fc", nn.Linear, jdnn.Linear, (12, 5), {}),
    ("fc_nb", nn.Linear, jdnn.Linear, (5, 3), dict(bias=False)),
]


class JaxSmall(nnx.Module):
    def __init__(self, rngs):
        for name, _, cls, args, kw in SMALL:
            setattr(self, name, cls(*args, rngs=rngs, **kw))


class TorchSmall(nn.Module):
    def __init__(self):
        super().__init__()
        for name, cls, _, args, kw in SMALL:
            setattr(self, name, cls(*args, **kw))


def _geometry(v, nd):
    """A conv argument as torch stores it (an nd-tuple, or a string)."""
    if isinstance(v, (str, tuple, list)):
        return v if isinstance(v, str) else tuple(v)
    return (v,) * nd


def test_dnn_to_bnn_small_model_matches_jax_surgery():
    """Each twin's class, geometry, device and flag; with MOPED its mu and
    rho equal the JAX surgery's on the same weights."""
    jm, tm = JaxSmall(nnx.Rngs(0)), TorchSmall()
    arrays = det_state(jax_arrays(jm), seed=6)
    import_torch_state_dict(jm, arrays)
    load_jax_state(tm, arrays)
    params = dict(PRIORS, moped_enable=True, moped_delta=0.2)
    jax_dnn_to_bnn(jm, params)
    dnn_to_bnn(tm, params)
    for name, cls, _, args, kw in SMALL:
        twin, jtwin = getattr(tm, name), getattr(jm, name)
        assert type(twin).__name__ == cls.__name__ + REPARAM, name
        assert twin.dnn_to_bnn_flag
        assert (twin.mu_bias is not None) == kw.get("bias", True), name
        if cls is nn.Linear:
            assert (twin.in_features, twin.out_features) == args[:2]
            mu = twin.mu_weight
        else:
            nd = len(twin.kernel_size)
            for attr in ("kernel_size", "stride", "padding", "dilation"):
                assert _geometry(getattr(twin, attr), nd) == _geometry(
                    getattr(jtwin, attr), nd), (name, attr)
            assert (twin.in_channels, twin.out_channels, twin.groups) == (
                jtwin.in_channels, jtwin.out_channels, jtwin.groups)
            mu = twin.mu_kernel
        assert mu.device.type == "cpu"
        for key in ("mu_kernel", "rho_kernel", "mu_weight", "rho_weight",
                    "mu_bias", "rho_bias"):
            if getattr(twin, key, None) is not None:
                np.testing.assert_allclose(
                    to_np(getattr(twin, key)),
                    np.asarray(getattr(jtwin, key)[...]), **EXACT,
                    err_msg=f"{name}.{key}")
    assert tm.c2s.padding == "same"
    with torch.no_grad():
        out = tm.c2s(torch.from_numpy(_x((1, 4, 5, 5))))
    assert isinstance(out, torch.Tensor) and out.shape == (1, 4, 5, 5)
    # dnn_to_bnn's MOPED leaves the priors scalar, as in JAX
    assert tm.c1.prior_weight_mu.shape == ()
    assert get_kl_loss(tm).item() == pytest.approx(
        float(jax_get_kl_loss(jm)), rel=1e-6)


def test_dnn_to_bnn_walks_containers_follows_devices_and_flipout():
    m = nn.Sequential(nn.Sequential(nn.Conv2d(3, 4, 3, device="meta"),
                                    nn.ReLU()),
                      nn.Linear(4, 2, device="meta"))
    dnn_to_bnn(m, dict(PRIORS, type="Flipout"))
    assert type(m[0][0]) is tl.Conv2dFlipout and type(m[0][1]) is nn.ReLU
    assert type(m[1]) is tl.LinearFlipout
    assert m[0][0].mu_kernel.device.type == "meta"
    assert m[1].mu_weight.device.type == "meta"
    # an already Bayesian layer is left as it is
    first = m[1]
    dnn_to_bnn(m, PRIORS)
    assert m[1] is first


def test_dnn_to_bnn_refusals():
    for mod, err, item in (
            (nn.LSTM(3, 4, num_layers=2), ValueError, "num_layers"),
            (nn.Conv2d(3, 4, 3, padding=1, padding_mode="reflect"),
             ValueError, "padding_mode")):
        with pytest.raises(err, match=item):
            dnn_to_bnn(nn.Sequential(mod), PRIORS)


def test_dnn_to_bnn_resnet18_structure_and_emission():
    """Every conv and the head of a deterministic ResNet-18 become
    Bayesian twins (the downsample ``Sequential`` walked), on the layer's
    device, with the keys of the Bayesian zoo's ResNet-18; the converted
    model trains through the vmap emission, the deterministic one only
    through the loop."""
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_variational_large as rvl,
    )
    model = tdet.resnet18(num_classes=10,
                          generator=torch.Generator().manual_seed(0))
    model.train()
    assert tmc._resolve_emission(model, 4, True) == "scan"
    name, mod = tmc._draw_axis_refusal(model)
    assert type(mod) is nn.Conv2d and name == "conv1"
    dnn_to_bnn(model, PRIORS)
    twins = [m for m in model.modules()
             if isinstance(m, tl.BaseVariationalLayer)]
    assert len(twins) == 21  # 17 convs, 3 downsample convs, the head
    assert all(m.dnn_to_bnn_flag for m in twins)
    assert type(model.layer2[0].downsample[0]) is tl.Conv2dReparameterization
    assert type(model.fc) is tl.LinearReparameterization
    assert not any(type(m) in (nn.Conv2d, nn.Linear)
                   for m in model.modules())
    assert set(model.state_dict()) == set(rvl.resnet18(
        num_classes=10).state_dict())
    assert tmc._resolve_emission(model, 4, True) == "vmap"
    assert tmc._resolve_emission(model, 1, True) == "scan"
    assert tmc._resolve_emission(model.eval(), 4, False) == "scan"


def test_converted_resnet18_matches_jax_surgery_and_forward():
    """Deterministic ResNet-18 on shared weights, converted with MOPED in
    both packages: the same state, and the same forward on one injected
    draw of every layer (bare logits from the deterministic forward)."""
    from bayesian_torch_tpu.layers.base_variational_layer import Presampled
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    jm, tm, _ = resnet18_twins(seed=7)
    params = dict(PRIORS, moped_enable=True, moped_delta=0.1)
    jax_dnn_to_bnn(jm, params)
    dnn_to_bnn(tm, params)
    after, state = jax_arrays(jm), tm.state_dict()
    assert set(state) == set(after)
    for key, v in state.items():
        np.testing.assert_allclose(to_np(v), after[key], **EXACT,
                                   err_msg=key)
    noise = draw_noise(tm, 1, seed=8)
    jax_layers = _jax_layers_by_name(jm)
    for name, tl_ in tm.named_modules():
        if name not in noise:
            continue
        jl_, e = jax_layers[name], noise[name]
        mu, rho = tmc._posterior(tl_)
        w = (mu + sigma_from_rho(rho) * torch.from_numpy(e["w"][0])).detach()
        tl_._presampled_w = w
        jl_._presampled_w = Presampled(jnp.asarray(w.numpy()))
        if "b" in e:
            b = (tl_.mu_bias + sigma_from_rho(tl_.rho_bias)
                 * torch.from_numpy(e["b"][0])).detach()
            tl_._presampled_b = b
            jl_._presampled_b = Presampled(jnp.asarray(b.numpy()))
    x = _x((4, 3, 64, 64), seed=9)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.shape == (4, 10)
    np.testing.assert_allclose(to_np(got), np.asarray(jm(jnp.asarray(x))),
                               **TOL)
    assert get_kl_loss(tm).item() == pytest.approx(
        float(jax_get_kl_loss(jm)), rel=1e-6)


@pytest.mark.parametrize("reduce", [None, "mean"])
def test_converted_model_mc_forward_matches_jax(monkeypatch, reduce):
    """The converted narrow ResNet's MC-3 draw loop (eval mode, presample
    on) against the JAX scan emission on the same injected draws."""
    from bayesian_torch_tpu.layers.base_variational_layer import Presampled
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )

    S = 3
    jm, tm, _ = converted_tiny_twins(seed=17)
    set_jax_eval(jm)
    tm.eval()
    rs = np.random.RandomState(18)
    layers = set(iter_bayesian_layers(tm))
    stacks = {}  # by module name: nnx rebuilds a model in another order
    for name, layer in tm.named_modules():
        if layer not in layers:
            continue
        mu, _ = tmc._posterior(layer)
        attrs = {"_presampled_w": rs.normal(0, 0.3, (S,) + tuple(mu.shape))}
        if layer.mu_bias is not None:
            attrs["_presampled_b"] = rs.normal(
                0, 0.3, (S,) + tuple(layer.mu_bias.shape))
        stacks[name] = {k: v.astype(np.float32) for k, v in attrs.items()}

    def jax_presample(model, num_mc, **_):
        touched = []
        for name, layer in _jax_layers_by_name(model).items():
            for attr, v in stacks[name].items():
                setattr(layer, attr, Presampled(jnp.asarray(v)))
            touched.append((layer, list(stacks[name])))
        return touched

    monkeypatch.setattr(jmc, "_presample_layers_xla", jax_presample)
    monkeypatch.setattr(tmc, "_presample_layers", lambda model, num_mc: [
        (layer, {k: torch.from_numpy(v) for k, v in stacks[name].items()})
        for name, layer in model.named_modules() if name in stacks])
    x = _x((2, 3, 16, 16), seed=19)
    want = jmc.mc_forward(jm, jnp.asarray(x), S, emission="scan",
                          presample="xla", reduce=reduce, return_kl=False)
    got = tmc.mc_forward(tm, torch.from_numpy(x), S, presample="on",
                         reduce=reduce, return_kl=False)
    assert got.shape == ((2, 10) if reduce else (S, 2, 10))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_dnn2bnn_elbo_loss_matches_jax_trainer(monkeypatch):
    """The dnn2bnn trainer's loss (CE of the MC-mean logits + KL / batch)
    on the converted narrow ResNet in training mode, the same injected
    draws in both packages."""
    import optax

    from bayesian_torch_tpu_torch.examples import _engine as engine

    jm, tm, _ = converted_tiny_twins(seed=10)
    set_jax_eval(jm, training=True)
    tm.train()
    S, B = 2, 4
    inject_draws(monkeypatch, draw_noise(tm, S, seed=11))
    rs = np.random.RandomState(12)
    x = rs.randn(B, 3, 16, 16).astype(np.float32)
    y = rs.randint(0, 10, B).astype(np.int32)

    outs = jmc.mc_forward(jm, jnp.asarray(x), S, return_kl=False,
                          presample="on", emission="vmap")
    ce = optax.softmax_cross_entropy_with_integer_labels(
        outs.mean(axis=0), jnp.asarray(y)).mean()
    want = float(ce + jax_get_kl_loss(jm) / B)

    real = tmc.mc_forward
    monkeypatch.setattr(engine, "mc_forward",
                        lambda *a, **k: real(*a, presample="on", **k))
    loss = engine.make_dnn2bnn_loss(S, B)(tm, torch.from_numpy(x),
                                          torch.from_numpy(y))
    assert loss.item() == pytest.approx(want, rel=1e-4, abs=1e-4)
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in tm.parameters())


# --- MOPED and freeze_batchnorm --------------------------------------------


def _moped_twins(seed):
    """JAX and port Bayesian ResNet-18 (random posteriors) and
    deterministic ResNet-18 (random weights), each pair on shared
    weights."""
    from bayesian_torch_tpu.models.bayesian.resnet_variational_large import (
        resnet18 as jax_bayes18,
    )
    from bayesian_torch_tpu.models.deterministic.resnet_large import (
        resnet18 as jax_det18,
    )
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_variational_large as rvl,
    )
    jb = jax_bayes18(num_classes=10, rngs=nnx.Rngs(seed))
    arrays = random_state(jax_arrays(jb), seed=seed)
    import_torch_state_dict(jb, arrays)
    tb = rvl.resnet18(num_classes=10,
                      generator=torch.Generator().manual_seed(seed))
    load_jax_state(tb, arrays)
    jd, td, _ = det_twins(
        lambda rngs: jax_det18(num_classes=10, rngs=rngs),
        lambda g: tdet.resnet18(num_classes=10, generator=g), seed + 1)
    return jb, tb, jd, td, arrays


def _check_moped(jb, tb):
    after = jax_arrays(jb)
    for key, v in tb.state_dict().items():
        np.testing.assert_allclose(to_np(v), after[key], **EXACT,
                                   err_msg=key)
    layers = [(n, m) for n, m in tb.named_modules()
              if isinstance(m, tl.BaseVariationalLayer)]
    assert len(layers) == 21
    for name, layer in layers:
        jlayer = jb
        for part in name.split("."):
            jlayer = jlayer[int(part)] if part.isdigit() else getattr(
                jlayer, part)
        for attr in ("prior_weight_mu", "prior_bias_mu"):
            got = getattr(layer, attr)
            if got is None:
                continue
            want = np.asarray(getattr(jlayer, attr)[...])
            assert tuple(got.shape) == want.shape != ()
            np.testing.assert_allclose(to_np(got), want, **EXACT,
                                       err_msg=f"{name}.{attr}")
    # priors stay non-persistent: a checkpoint keeps none
    assert not any("prior" in k for k in tb.state_dict())
    assert get_kl_loss(tb).item() == pytest.approx(
        float(jax_get_kl_loss(jb)), rel=1e-6)


def test_moped_matches_jax(tmp_path):
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_variational_large as rvl,
    )
    jb, tb, jd, td, arrays = _moped_twins(seed=13)
    jutil.MOPED(jb, jd, None, delta=0.2)
    assert MOPED(tb, td, None, delta=0.2) is tb
    _check_moped(jb, tb)
    assert tb.conv1.prior_weight_mu.dtype == torch.float32
    # from a port checkpoint of the deterministic model
    path = tmp_path / "det.pt"
    save_checkpoint(td, path)
    tb2 = rvl.resnet18(num_classes=10)
    load_jax_state(tb2, arrays)
    fresh = tdet.resnet18(num_classes=10,
                          generator=torch.Generator().manual_seed(99))
    MOPED(tb2, fresh, str(path), delta=0.2)
    _check_moped(jb, tb2)


def test_moped_refuses_a_mismatched_pair():
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_variational_large as rvl,
    )
    bayes = rvl.resnet18(num_classes=10)
    with pytest.raises(ValueError, match="weight"):
        MOPED(bayes, tdet.resnet18(num_classes=7), None, 0.5)
    with pytest.raises(ValueError, match="modules"):
        MOPED(bayes, tdet.resnet34(num_classes=10), None, 0.5)
    wrong = tdet.resnet18(num_classes=10)
    wrong.layer1[0].bn1 = nn.Identity()
    with pytest.raises(ValueError, match="BatchNorm2d"):
        MOPED(bayes, wrong, None, 0.5)


def test_freeze_batchnorm_matches_jax_count_and_freezes_statistics():
    from bayesian_torch_tpu.models.bayesian.resnet_variational_large import (
        resnet18 as jax_bayes18,
    )
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_variational_large as rvl,
    )
    jb = nnx.eval_shape(lambda: jax_bayes18(num_classes=10,
                                            rngs=nnx.Rngs(0)))
    tb = rvl.resnet18(num_classes=10,
                      generator=torch.Generator().manual_seed(14))
    set_jax_eval(jb, training=True)
    tb.train()
    n = freeze_batchnorm(tb)
    assert n == jutil.freeze_batchnorm(jb) == 20
    assert all(not m.training for m in tb.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    assert tb.conv1.training
    before = {k: v.clone() for k, v in tb.state_dict().items()}
    x = torch.from_numpy(_x((2, 3, 32, 32), seed=15))
    for num_mc in (1, 2):
        outs, kl = tmc.mc_forward(tb, x, num_mc)
        (outs.float().mean() + kl).backward()
    for key, v in tb.state_dict().items():
        assert torch.equal(v, before[key]), key
    tb.train()
    assert all(m.training for m in tb.modules())


# --- INT8 conversion and the entry point -----------------------------------


def test_converted_resnet_folds_into_int8_with_and_without_fusion():
    """bnn_to_qbnn finds the conv/BN pairs of a converted deterministic
    ResNet (conv{i}/bn{i}, the downsample Sequential), and its forward
    runs on QTensor activations."""
    from bayesian_torch_tpu_torch.layers.quantized_base import (
        _QuantizedLayerBase,
    )
    from bayesian_torch_tpu_torch.quantization import convert, prepare

    x = torch.from_numpy(_x((2, 3, 32, 32), seed=16))
    for fuse in (False, True):
        model = tdet.resnet18(num_classes=10,
                              generator=torch.Generator().manual_seed(0))
        dnn_to_bnn(model, dict(PRIORS, posterior_rho_init=-4.0))
        model.eval()
        prepare(model)
        with torch.no_grad():
            model(x)
        convert(model, fuse_conv_bn=fuse, quantize_activations=fuse)
        quantized = [m for m in model.modules()
                     if isinstance(m, _QuantizedLayerBase)]
        assert len(quantized) == 21
        identities = sum(type(m) is nn.Identity for m in model.modules())
        assert identities == (20 if fuse else 0)
        with torch.no_grad():
            out = tmc.mc_forward(model, x, 2, return_kl=False)
        assert out.shape == (2, 2, 10) and bool(torch.isfinite(out).all())


def test_graft_entry_runs_on_the_cpu():
    from bayesian_torch_tpu_torch.graft_entry import entry

    fn, args = entry(device="cpu")
    model, x = args
    assert x.shape == (2, 3, 64, 64) and x.device.type == "cpu"
    assert not model.training
    logits, kl = fn(*args)
    assert logits.shape == (2, 1000) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()) and float(kl) > 0
