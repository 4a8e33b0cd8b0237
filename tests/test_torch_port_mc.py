"""Port ``mc_forward`` against the JAX scan emission on the narrow ResNet,
with the same per-draw weights injected into both packages; f32 on the
CPU, tolerance 1e-4 (as in test_torch_port_model.py). Also the port's own
contract: presampling, cleanup, the unported modes, fresh draws. The
training path is in test_torch_port_train.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_torch_tpu.layers.base_variational_layer import Presampled
from bayesian_torch_tpu.models.dnn_to_bnn import (
    iter_bayesian_layers as jax_iter_layers,
)
from bayesian_torch_tpu.parallel import mc as jmc
from bayesian_torch_tpu_torch.models.dnn_to_bnn import iter_bayesian_layers
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from bayesian_torch_tpu_torch.parallel import mc as tmc
from tests._torch_port import tiny_twins, to_np

S = 3
TOL = dict(rtol=1e-4, atol=1e-4)


def _draws(tm, seed=0):
    """Per-draw (S, ...) weights and biases for every Bayesian layer."""
    rs = np.random.RandomState(seed)
    stacks = []
    for layer in iter_bayesian_layers(tm):
        mu, _ = tmc._posterior(layer)
        attrs = {"_presampled_w": rs.normal(
            0, 0.3, (S,) + tuple(mu.shape)).astype(np.float32)}
        if layer.mu_bias is not None:
            attrs["_presampled_b"] = rs.normal(
                0, 0.3, (S,) + tuple(layer.mu_bias.shape)).astype(np.float32)
        stacks.append(attrs)
    return stacks


@pytest.mark.parametrize("reduce", [None, "mean"])
@pytest.mark.parametrize("return_kl", [True, False])
def test_mc_forward_matches_jax_scan(monkeypatch, reduce, return_kl):
    jm, tm, _ = tiny_twins(seed=1)
    stacks = _draws(tm)

    def jax_presample(model, num_mc, **_):
        touched = []
        for layer, attrs in zip(jax_iter_layers(model), stacks):
            for name, v in attrs.items():
                setattr(layer, name, Presampled(jnp.asarray(v)))
            touched.append((layer, list(attrs)))
        return touched

    def torch_presample(model, num_mc):
        return [(layer, {k: torch.from_numpy(v) for k, v in attrs.items()})
                for layer, attrs in zip(iter_bayesian_layers(model), stacks)]

    # both packages' presample hooks hand out the same injected draws
    monkeypatch.setattr(jmc, "_presample_layers_xla", jax_presample)
    monkeypatch.setattr(tmc, "_presample_layers", torch_presample)
    x = np.random.RandomState(2).randn(2, 3, 16, 16).astype(np.float32)
    want = jmc.mc_forward(jm, jnp.asarray(x), S, emission="scan",
                          presample="xla", reduce=reduce,
                          return_kl=return_kl)
    got = tmc.mc_forward(tm, torch.from_numpy(x), S, presample="on",
                         reduce=reduce, return_kl=return_kl)
    if return_kl:
        (want, want_kl), (got, got_kl) = want, got
        assert float(got_kl) == pytest.approx(float(want_kl), rel=1e-6)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.shape == ((2, 10) if reduce else (S, 2, 10))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    # the transient per-draw attributes are gone, compute_kl restored
    for layer in iter_bayesian_layers(tm):
        assert not hasattr(layer, "_presampled_w")
        assert not hasattr(layer, "_presampled_b")
        assert layer.compute_kl is True


def test_presample_with_zero_sigma_returns_each_mu():
    """sigma = 0 (rho = -1e4): one flat sampler launch, split back into
    every layer's own mu, in the layer's shape and order."""
    _, tm, _ = tiny_twins(seed=3, rho=-1e4)
    touched = tmc._presample_layers(tm, S)
    layers = list(iter_bayesian_layers(tm))
    assert [layer for layer, _ in touched] == layers
    for layer, attrs in touched:
        mu, _ = tmc._posterior(layer)
        w = attrs["_presampled_w"]
        assert w.shape == (S,) + tuple(mu.shape) and w.dtype == torch.float32
        for s in range(S):
            torch.testing.assert_close(w[s], mu.detach(), rtol=0, atol=0)
        if layer.mu_bias is not None:
            torch.testing.assert_close(
                attrs["_presampled_b"],
                layer.mu_bias.detach().expand(S, -1), rtol=0, atol=0)


def test_presample_uses_one_seed_and_compute_dtype():
    _, tm, _ = tiny_twins(seed=4)
    for layer in iter_bayesian_layers(tm):
        layer.compute_dtype = torch.bfloat16
    touched = tmc._presample_layers(tm, 2)
    assert all(a["_presampled_w"].dtype == torch.bfloat16
               for _, a in touched)
    out = tmc.mc_forward(tm, torch.randn(2, 3, 16, 16), 2, reduce="mean",
                         return_kl=False)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_presample_launches_once_per_compute_dtype(monkeypatch):
    """Layers in different compute dtypes get their draws in their own
    dtype (as presample="off" samples them), one sampler call per dtype;
    sigma = 0, so each draw is the layer's mu cast exactly."""
    _, tm, _ = tiny_twins(seed=9, rho=-1e4)
    layers = list(iter_bayesian_layers(tm))
    for layer in layers[::2]:
        layer.compute_dtype = torch.bfloat16
    calls = []
    real = tmc.sample_scaled_normals_batch
    monkeypatch.setattr(tmc, "sample_scaled_normals_batch",
                        lambda *a: calls.append(a[-1]) or real(*a))
    touched = tmc._presample_layers(tm, S)
    assert sorted(map(str, calls)) == ["torch.bfloat16", "torch.float32"]
    assert [layer for layer, _ in touched] == layers
    for layer, attrs in touched:
        mu, _ = tmc._posterior(layer)
        dtype = layer.compute_dtype or torch.float32
        w = attrs["_presampled_w"]
        assert w.dtype == dtype and w.shape == (S,) + tuple(mu.shape)
        torch.testing.assert_close(
            w, mu.detach().to(dtype).expand_as(w), rtol=0, atol=0)


def test_fresh_draws_across_calls_and_samples():
    _, tm, _ = tiny_twins(seed=5, rho=-1.0)
    x = torch.randn(2, 3, 16, 16)
    launches = ka.sample_scaled_normals_batch.launches
    a, kl_a = tmc.mc_forward(tm, x, S)
    b, kl_b = tmc.mc_forward(tm, x, S)
    assert a.shape == (S, 2, 10)
    assert not torch.allclose(a, b)
    assert not torch.allclose(a[0], a[1]) and not torch.allclose(a[1], a[2])
    assert float(kl_a) == float(kl_b)
    assert ka.sample_scaled_normals_batch.launches == launches  # CPU: plain
    off = tmc.mc_forward(tm, x, S, presample="off", return_kl=False)
    assert off.shape == (S, 2, 10) and not torch.allclose(off[0], off[1])


def test_presample_off_is_layer_sampling_and_auto_is_on(monkeypatch):
    _, tm, _ = tiny_twins(seed=6)
    calls = []
    real = tmc._presample_layers
    monkeypatch.setattr(tmc, "_presample_layers",
                        lambda m, n: calls.append(n) or real(m, n))
    x = torch.randn(1, 3, 16, 16)
    tmc.mc_forward(tm, x, 2)
    tmc.mc_forward(tm, x, 2, presample="on")
    tmc.mc_forward(tm, x, 2, presample="off")
    tmc.mc_forward(tm, x, 1)  # one draw samples inside the layers
    assert calls == [2, 2]


def test_eval_only_guard_and_unported_modes():
    """Training mode is ported (a module in training mode now trains, with
    gradients and one BN update), and so is the vmap emission
    (test_torch_port_vmap.py), and so is the structured emission
    (test_torch_port_modes.py), and so is ``mesh=`` (a mesh of one
    process gives the forward without a mesh; many ranks:
    test_torch_port_parallel.py), which refuses what is not a mesh; the
    TPU presample variants still raise, and so does a plain torch BN that
    would update once per draw."""
    from bayesian_torch_tpu_torch.parallel import make_mesh

    _, tm, _ = tiny_twins(seed=7)
    x = torch.randn(2, 3, 16, 16)
    for kw in (dict(presample="xla"), dict(presample="hash")):
        with pytest.raises(NotImplementedError):
            tmc.mc_forward(tm, x, 2, **kw)
    with pytest.raises(TypeError, match="make_mesh"):
        tmc.mc_forward(tm, x, 2, mesh=object())
    gen = tm.conv1.generator.get_state()
    want = tmc.mc_forward(tm, x, 2, return_kl=False, emission="vmap")
    tm.conv1.generator.set_state(gen)
    got = tmc.mc_forward(tm, x, 2, return_kl=False, mesh=make_mesh())
    assert torch.equal(got, want)  # "auto" is vmap under a mesh
    out = tmc.mc_forward(tm, x, 2, return_kl=False, structured=True)
    assert out.shape == (2, 2, 10)
    for kw in (dict(emission="bogus"), dict(reduce="sum"),
               dict(presample="bogus"), dict(bn_stats="bogus")):
        with pytest.raises(ValueError):
            tmc.mc_forward(tm, x, 2, **kw)
    tm.bn1.train()
    out, kl = tmc.mc_forward(tm, x, 2)
    assert out.shape == (2, 2, 10) and out.requires_grad
    out.sum().backward()
    assert tm.conv1.rho_kernel.grad is not None
    assert int(tm.bn1.num_batches_tracked) == 1
    assert not tm.bn1.stats_frozen and tm.bn1._mc_stats is None
    tm.bn1 = torch.nn.BatchNorm2d(16).train()
    with pytest.raises(NotImplementedError, match="once per draw"):
        tmc.mc_forward(tm, x, 2)
    tm.eval()
    out = tmc.mc_forward(tm, x, 2, return_kl=False, compute_kl=True)
    assert out.shape == (2, 2, 10) and not out.requires_grad


def _spy_emissions(monkeypatch):
    calls = []
    for name in ("_forward_loop", "_forward_draws"):
        real = getattr(tmc, name)
        monkeypatch.setattr(tmc, name, lambda *a, _n=name, _r=real:
                            calls.append(_n) or _r(*a))
    return calls


@pytest.mark.parametrize("training,num_mc,emission,want", [
    (True, 3, "auto", "_forward_draws"), (True, 1, "auto", "_forward_loop"),
    (False, 3, "auto", "_forward_loop"), (True, 3, "scan", "_forward_loop"),
    (False, 3, "vmap", "_forward_draws")])
def test_auto_emission_follows_the_jax_rule(monkeypatch, training, num_mc,
                                            emission, want):
    """``emission="auto"`` takes the vmap emission for a model in training
    mode with more than one draw, as the JAX ``_resolve_emission`` does,
    and the draw loop in eval mode (the JAX rule's TPU work threshold is
    not ported); "scan" and "vmap" are taken as asked."""
    jm, tm, _ = tiny_twins(seed=10)
    tm.train(training)
    calls = _spy_emissions(monkeypatch)
    out, _ = tmc.mc_forward(tm, torch.randn(2, 3, 16, 16), num_mc,
                            emission=emission)
    assert calls == [want] and out.shape == (num_mc, 2, 10)
    if training and num_mc > 1:
        from tests._torch_port import set_jax_eval

        set_jax_eval(jm, training=True)
        assert jmc._resolve_emission(jm, jnp.zeros((2, 3, 16, 16)), num_mc,
                                     None, False) == "vmap"


def test_auto_emission_keeps_the_loop_for_a_module_without_draw_axis(
        monkeypatch):
    """A model holding a module that cannot take the draw axis (here a
    plain ``torch.nn.Linear``; a quantized layer in
    test_torch_port_quant.py) trains through the loop under "auto" and
    raises, naming the module, under "vmap"."""
    _, tm, _ = tiny_twins(seed=11)
    tm.extra = torch.nn.Linear(2, 2)
    tm.train()
    assert tmc._resolve_emission(tm, 3, True) == "scan"
    calls = _spy_emissions(monkeypatch)
    tmc.mc_forward(tm, torch.randn(2, 3, 16, 16), 3)
    assert calls == ["_forward_loop"]
    with pytest.raises(NotImplementedError, match="'extra'"):
        tmc.mc_forward(tm, torch.randn(2, 3, 16, 16), 3, emission="vmap")


def test_cleanup_after_a_failing_forward():
    _, tm, _ = tiny_twins(seed=8)
    with pytest.raises(RuntimeError):
        tmc.mc_forward(tm, torch.randn(1, 5, 16, 16), 2, return_kl=False)
    for layer in iter_bayesian_layers(tm):
        assert not hasattr(layer, "_presampled_w")
        assert layer.compute_kl is True
