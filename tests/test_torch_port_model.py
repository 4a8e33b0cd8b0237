"""Port blocks and models against the JAX classes on shared weights, in
eval mode, f32 on the CPU. Tolerance 1e-4 absolute on outputs of order 1
(ten convolutions deep, each summed in another order by another library);
KL to 1e-6 relative.

The full ResNet-50 is held against the JAX model's structure only
(``nnx.eval_shape``): building and running it in JAX here would take
tens of seconds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from bayesian_torch_tpu.layers.base_variational_layer import Presampled
from bayesian_torch_tpu.models import _large_resnet as jres
from bayesian_torch_tpu.models.dnn_to_bnn import (
    get_kl_loss as jax_get_kl_loss,
    iter_bayesian_layers as jax_iter_layers,
)
from bayesian_torch_tpu.utils.checkpoint import (_torch_key_for,
                                                 import_torch_state_dict)
from bayesian_torch_tpu_torch.models import _large_resnet as tres
from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large import (
    resnet50,
)
from bayesian_torch_tpu_torch.models.dnn_to_bnn import (get_kl_loss,
                                                        iter_bayesian_layers)
from bayesian_torch_tpu_torch.parallel import mc_forward
from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
from tests._torch_port import (REPARAM, jax_arrays, random_state,
                               set_jax_eval, tiny_twins, to_np)

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_bottleneck_with_downsample_matches_jax():
    import bayesian_torch_tpu.layers as jl
    import bayesian_torch_tpu.nn as jdnn
    import bayesian_torch_tpu_torch.layers as tl
    from bayesian_torch_tpu_torch.nn import Sequential

    rngs = nnx.Rngs(0)
    jdown = jdnn.Sequential(
        jl.Conv2dReparameterization(8, 32, 1, stride=2, bias=False,
                                    rngs=rngs),
        jl.BatchNorm2dLayer(32))
    jb = jres.Bottleneck(8, 8, 2, jdown, estimator=REPARAM, rngs=rngs)
    arrays = random_state(jax_arrays(jb), seed=1, rho=-30.0)
    import_torch_state_dict(jb, arrays)
    set_jax_eval(jb)
    tdown = Sequential(tl.Conv2dReparameterization(8, 32, 1, stride=2,
                                                   bias=False),
                       tl.BatchNorm2dLayer(32))
    tb = tres.Bottleneck(8, 8, 2, tdown, estimator=REPARAM,
                         generator=torch.Generator().manual_seed(0))
    load_jax_state(tb, arrays)
    tb.eval()
    x = _x((2, 8, 8, 8))
    jo, jk = jb(jnp.asarray(x))
    to, tk = tb(torch.from_numpy(x))
    assert to.shape == (2, 32, 4, 4)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    # four Bayesian convs, the downsample's KL threaded by Sequential
    assert tk.item() == pytest.approx(float(jk), rel=1e-6)
    assert tk.item() == pytest.approx(get_kl_loss(tb).item(), rel=1e-6)


def test_tiny_resnet_at_rho_minus30_matches_jax():
    """sigma = softplus(-30) ~ 1e-13: each package draws its own noise
    and both forwards equal the mean network."""
    jm, tm, _ = tiny_twins(seed=2, rho=-30.0)
    x = _x((2, 3, 16, 16), seed=3)
    jo, jk = jm(jnp.asarray(x))
    with torch.no_grad():
        to, tk = tm(torch.from_numpy(x))
    assert to.shape == (2, 10)
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    assert float(tk) == pytest.approx(float(jk), rel=1e-6)


def test_tiny_resnet_with_injected_weights_matches_jax():
    jm, tm, _ = tiny_twins(seed=4)
    jlayers = list(jax_iter_layers(jm))
    tlayers = list(iter_bayesian_layers(tm))
    assert len(jlayers) == len(tlayers) == 9
    rs = np.random.RandomState(5)
    for jl_, tl_ in zip(jlayers, tlayers):
        mu = tl_.mu_kernel if hasattr(tl_, "mu_kernel") else tl_.mu_weight
        w = rs.normal(0, 0.3, tuple(mu.shape)).astype(np.float32)
        jl_._presampled_w = Presampled(jnp.asarray(w))
        tl_._presampled_w = torch.from_numpy(w)
        if tl_.mu_bias is not None:
            b = rs.normal(0, 0.3, tuple(tl_.mu_bias.shape)).astype(np.float32)
            jl_._presampled_b = Presampled(jnp.asarray(b))
            tl_._presampled_b = torch.from_numpy(b)
    x = _x((2, 3, 16, 16), seed=6)
    jo, jk = jm(jnp.asarray(x))
    with torch.no_grad():
        to, tk = tm(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), **TOL)
    # the forward KL, get_kl_loss and the JAX values all agree
    assert float(tk) == pytest.approx(float(jk), rel=1e-6)
    assert get_kl_loss(tm).item() == pytest.approx(float(tk), rel=1e-6)
    assert float(jax_get_kl_loss(jm)) == pytest.approx(float(jk), rel=1e-6)


@pytest.fixture(scope="module")
def rn50_shapes():
    """{torch key: shape} of the JAX ResNet-50, built abstractly."""
    from bayesian_torch_tpu.models.bayesian.resnet_variational_large import (
        resnet50 as jax_resnet50,
    )

    model = nnx.eval_shape(lambda: jax_resnet50(num_classes=1000,
                                                rngs=nnx.Rngs(0)))
    state = nnx.state(model, nnx.Any(nnx.Param, nnx.BatchStat))
    return {_torch_key_for(p): tuple(v.get_value().shape)
            for p, v in nnx.to_flat_state(state)}


@pytest.fixture(scope="module")
def port_rn50():
    return resnet50(num_classes=1000,
                    generator=torch.Generator().manual_seed(0))


def test_resnet50_state_dict_equals_jax_keys_and_shapes(rn50_shapes,
                                                        port_rn50):
    ours = {k: tuple(v.shape) for k, v in port_rn50.state_dict().items()}
    assert ours == rn50_shapes
    assert "layer1.0.downsample.0.mu_kernel" in ours
    assert ours["fc.mu_bias"] == (1000,)
    n = sum(v.numel() for k, v in port_rn50.state_dict().items()
            if k.rsplit(".", 1)[-1] in ("mu_kernel", "mu_weight"))
    assert n == 25_502_912  # Bayesian weights (biases apart)


def test_resnet50_load_strict_and_mc_forward(rn50_shapes, port_rn50):
    rs = np.random.default_rng(0)
    arrays = {}
    for key, shape in rn50_shapes.items():
        name = key.rsplit(".", 1)[-1]
        if name == "num_batches_tracked":
            arrays[key] = np.zeros(shape, np.int32)
        elif name == "running_var" or name == "weight":
            arrays[key] = np.ones(shape, np.float32)
        elif name.startswith("rho"):
            arrays[key] = np.full(shape, -5.0, np.float32)
        else:
            arrays[key] = (0.02 * rs.standard_normal(shape, np.float32))
    missing = dict(arrays)
    missing.pop("fc.rho_bias")
    with pytest.raises(ValueError, match="missing keys"):
        load_jax_state(port_rn50, missing)
    wrong = dict(arrays)
    wrong["conv1.mu_kernel"] = np.zeros((64, 3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="shape errors"):
        load_jax_state(port_rn50, wrong)
    extra = dict(arrays, **{"fc.extra": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="unexpected keys"):
        load_jax_state(port_rn50, extra)
    assert load_jax_state(port_rn50, arrays) == ([], [])
    torch.testing.assert_close(port_rn50.conv1.mu_kernel.detach(),
                               torch.from_numpy(arrays["conv1.mu_kernel"]))
    port_rn50.eval()
    x = torch.from_numpy(_x((2, 3, 64, 64), seed=7))
    out, kl = mc_forward(port_rn50, x, num_mc=2, reduce="mean")
    assert out.shape == (2, 1000) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and float(kl) > 0


def test_factories_and_unported_estimators():
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_variational_large as rvl,
    )
    m = rvl.resnet18(num_classes=10)
    assert isinstance(m.layer1[0], tres.BasicBlock) and m.fc.out_features == 10
    flip = tres.LargeResNet(tres.Bottleneck, [1, 1, 1, 1],
                            estimator="Flipout")
    assert type(flip.conv1).__name__ == "Conv2dFlipout"
    with pytest.raises(NotImplementedError):
        tres.LargeResNet(tres.Bottleneck, [1, 1, 1, 1],
                         estimator="Deterministic")
    with pytest.raises(NotImplementedError):
        rvl.resnet50(pretrained=True)


def test_resnet18_forward_matches_jax_structure():
    """BasicBlock ResNet: same keys as the JAX model and a finite eval
    forward through every stage."""
    from bayesian_torch_tpu.models.bayesian.resnet_variational_large import (
        resnet18 as jax_resnet18,
    )
    jm = nnx.eval_shape(lambda: jax_resnet18(num_classes=10,
                                             rngs=nnx.Rngs(0)))
    state = nnx.state(jm, nnx.Any(nnx.Param, nnx.BatchStat))
    keys = {_torch_key_for(p) for p, _ in nnx.to_flat_state(state)}
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_variational_large as rvl,
    )
    tm = rvl.resnet18(num_classes=10).eval()
    assert set(tm.state_dict()) == keys
    with torch.no_grad():
        out, kl = tm(torch.from_numpy(_x((1, 3, 32, 32))))
    assert out.shape == (1, 10) and bool(torch.isfinite(out).all())
