"""Shared helpers of the torch-port parity tests (tests/test_torch_port_*).

Inputs are numpy arrays made from a fixed seed and handed to both
packages. torch runs on one thread per xdist worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx
from torch import nn

from bayesian_torch_tpu.utils.checkpoint import _torch_key_for

torch.set_num_threads(1)

REPARAM = "Reparameterization"
FLIPOUT = "Flipout"


def jax_state(model):
    """{torch-style key: variable} of an nnx model's Param, BatchStat and
    QuantParam state (the keys ``import_torch_state_dict`` maps by; a
    converted model's int8 weights and scales)."""
    from bayesian_torch_tpu.layers.quantized_base import QuantParam

    state = nnx.state(model, nnx.Any(nnx.Param, nnx.BatchStat, QuantParam))
    return {_torch_key_for(path): var
            for path, var in nnx.to_flat_state(state)}


def jax_arrays(model):
    return {k: np.asarray(v[...]) for k, v in jax_state(model).items()}


def random_state(arrays, seed=0, rho=None):
    """Replace every array with random values of a sensible range: mu
    N(0, 0.3), rho N(-4, 0.5) (or the constant ``rho``), BN affine and
    running statistics near 1 / 0."""
    rs = np.random.RandomState(seed)
    out = {}
    for key, a in arrays.items():
        name = key.rsplit(".", 1)[-1]
        shape = np.shape(a)
        if name.startswith("rho"):
            v = (rs.normal(-4.0, 0.5, shape) if rho is None
                 else np.full(shape, rho))
        elif name.startswith("mu"):
            v = rs.normal(0.0, 0.3, shape)
        elif name in ("weight", "running_var"):
            v = rs.uniform(0.5, 1.5, shape)
        elif name in ("bias", "running_mean"):
            v = rs.normal(0.0, 0.1, shape)
        else:  # num_batches_tracked
            out[key] = np.zeros(shape, np.int64)
            continue
        out[key] = v.astype(np.float32)
    return out


def set_jax_eval(model, training=False):
    for _, mod in nnx.iter_modules(model):
        if hasattr(mod, "training"):
            mod.training = training


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


# --- a narrow ResNet: stem, two Bottlenecks (one downsampling), head ---


def _spatial(data_format):
    """The spatial axes of a 2-d activation in ``data_format``."""
    return (1, 2) if data_format.endswith("C") else (2, 3)


class JaxTiny(nnx.Module):
    def __init__(self, rngs, estimator=REPARAM, data_format="NCHW"):
        import bayesian_torch_tpu.layers as layers
        import bayesian_torch_tpu.nn as dnn
        from bayesian_torch_tpu.models._large_resnet import Bottleneck

        conv = getattr(layers, f"Conv2d{estimator}")
        df = dict(data_format=data_format)
        self.data_format = data_format
        self.conv1 = conv(3, 16, 3, padding=1, bias=False, rngs=rngs, **df)
        self.bn1 = dnn.BatchNorm2d(16, **df)
        down = dnn.Sequential(
            conv(16, 32, 1, stride=2, bias=False, rngs=rngs, **df),
            layers.BatchNorm2dLayer(32, **df))
        self.layer1 = dnn.Sequential(
            Bottleneck(16, 8, 2, down, estimator=estimator, rngs=rngs, **df),
            Bottleneck(32, 8, estimator=estimator, rngs=rngs, **df))
        self.fc = getattr(layers, f"Linear{estimator}")(32, 10, rngs=rngs)

    def __call__(self, x):
        out, kl_sum = self.conv1(x)
        out = jax.nn.relu(self.bn1(out))
        for block in self.layer1:
            out, kl = block(out)
            kl_sum = kl_sum + kl
        out = out.mean(axis=_spatial(self.data_format))
        out, kl = self.fc(out)
        return out, kl_sum + kl


class TorchTiny(nn.Module):
    def __init__(self, generator=None, estimator=REPARAM,
                 data_format="NCHW"):
        super().__init__()
        import bayesian_torch_tpu_torch.layers as layers
        from bayesian_torch_tpu_torch.models._large_resnet import Bottleneck
        from bayesian_torch_tpu_torch.nn import BatchNorm2d, Sequential

        g = generator
        conv = getattr(layers, f"Conv2d{estimator}")
        df = dict(data_format=data_format)
        self.data_format = data_format
        self.conv1 = conv(3, 16, 3, padding=1, bias=False, generator=g, **df)
        self.bn1 = BatchNorm2d(16, **df)
        down = Sequential(
            conv(16, 32, 1, stride=2, bias=False, generator=g, **df),
            layers.BatchNorm2dLayer(32, **df))
        self.layer1 = nn.Sequential(
            Bottleneck(16, 8, 2, down, estimator=estimator, generator=g,
                       **df),
            Bottleneck(32, 8, estimator=estimator, generator=g, **df))
        self.fc = getattr(layers, f"Linear{estimator}")(32, 10, generator=g)

    def forward(self, x):
        out, kl_sum = self.conv1(x)
        out = torch.relu(self.bn1(out))
        for block in self.layer1:
            out, kl = block(out)
            kl_sum = kl_sum + kl
        out = out.mean(dim=_spatial(self.data_format))
        out, kl = self.fc(out)
        return out, kl_sum + kl


def tiny_twins(seed=0, rho=None, estimator=REPARAM, data_format="NCHW"):
    """(jax model, torch model, arrays): the narrow ResNet in both
    packages, eval mode, holding the same random weights; activations in
    ``data_format`` (NCHW, or channels-last NHWC)."""
    from bayesian_torch_tpu.utils.checkpoint import import_torch_state_dict
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state

    jm = JaxTiny(nnx.Rngs(params=seed, noise=seed + 1), estimator,
                 data_format)
    arrays = random_state(jax_arrays(jm), seed=seed, rho=rho)
    import_torch_state_dict(jm, arrays)
    set_jax_eval(jm)
    tm = TorchTiny(torch.Generator().manual_seed(seed), estimator,
                   data_format)
    load_jax_state(tm, arrays)
    tm.eval()
    return jm, tm, arrays


# --- the same per-draw weights injected into both packages -----------------


def draw_noise(tm, num_mc, seed=0):
    """numpy eps of every Bayesian layer of the torch model by module
    name: {"w": (S, ...), "b": (S, ...)}."""
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )
    from bayesian_torch_tpu_torch.parallel.mc import _posterior

    rs = np.random.RandomState(seed)
    layers = set(iter_bayesian_layers(tm))
    out = {}
    for name, layer in tm.named_modules():
        if layer not in layers:
            continue
        mu, _ = _posterior(layer)
        e = {"w": rs.randn(num_mc, *mu.shape).astype(np.float32)}
        if layer.mu_bias is not None:
            e["b"] = rs.randn(num_mc,
                              *layer.mu_bias.shape).astype(np.float32)
        out[name] = e
    return out


def inject_draws(monkeypatch, noise):
    """Both packages' presample hooks draw mu + softplus(rho) * eps from
    ``noise`` (``draw_noise``), differentiably. Layers are matched by
    name: nnx transforms rebuild the model with its attributes in another
    order."""
    from bayesian_torch_tpu.layers.base_variational_layer import Presampled
    from bayesian_torch_tpu.models.dnn_to_bnn import (
        iter_bayesian_layers as jax_iter_layers,
    )
    from bayesian_torch_tpu.ops.sampling import sigma_from_rho as jax_sigma
    from bayesian_torch_tpu.parallel import mc as jmc
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho
    from bayesian_torch_tpu_torch.parallel import mc as tmc

    def jax_presample(model, num_mc, **_):
        touched = []
        layers = set(map(id, jax_iter_layers(model)))
        for path, layer in nnx.iter_modules(model):
            if id(layer) not in layers:
                continue
            e = noise[_torch_key_for(path)]
            conv = getattr(layer, "mu_kernel", None) is not None
            mu = (layer.mu_kernel if conv else layer.mu_weight)[...]
            rho = (layer.rho_kernel if conv else layer.rho_weight)[...]
            layer._presampled_w = Presampled(mu + jax_sigma(rho) * e["w"])
            attrs = ["_presampled_w"]
            if "b" in e:
                layer._presampled_b = Presampled(
                    layer.mu_bias[...] + jax_sigma(layer.rho_bias[...])
                    * e["b"])
                attrs.append("_presampled_b")
            touched.append((layer, attrs))
        return touched

    def torch_presample(model, num_mc):
        touched = []
        layers = set(iter_bayesian_layers(model))
        for name, layer in model.named_modules():
            if layer not in layers:
                continue
            e = noise[name]
            mu, rho = tmc._posterior(layer)
            attrs = {"_presampled_w": mu + sigma_from_rho(rho)
                     * torch.from_numpy(e["w"])}
            if "b" in e:
                attrs["_presampled_b"] = (
                    layer.mu_bias + sigma_from_rho(layer.rho_bias)
                    * torch.from_numpy(e["b"]))
            touched.append((layer, attrs))
        return touched

    monkeypatch.setattr(jmc, "_presample_layers", jax_presample)
    monkeypatch.setattr(tmc, "_presample_layers", torch_presample)


# --- the Bayesian LSTM's per-step noise -------------------------------------


def _normal(key, shape, dtype=jnp.float32):
    """JAX's normal at ``shape``, drawn at the squeezed shape as
    ``sample_gaussian_weight`` draws it (the same values by flat index)."""
    squeezed = tuple(d for d in shape if d != 1) or (1,)
    return jax.random.normal(key, squeezed, dtype).reshape(shape)


def lstm_jax_noise(jm, T, B):
    """The noise the next forward of the JAX LSTM ``jm`` draws, as the
    port's hooks take it: ``{"eps_w", "eps_b"[, "sign_in", "sign_out"]}``,
    each a pair (ih, hh) with a leading T axis (per-step draws) or none.
    Read without touching the package: the base key from a clone of the
    layer's rngs, ``fold_in(t)`` and ``split`` per step, then each op's own
    split (``sampled_linear``: weight and bias; ``flipout_linear``: eps,
    bias eps and the sign keys, the signs from JAX's ``rademacher_fused``).
    Per-step normals come in the layer's compute dtype, as the ops draw
    them; the one draw per sequence in f32, as the layer samples it.
    """
    from bayesian_torch_tpu.ops.sampling import rademacher_fused

    base = nnx.clone(jm.rngs).noise()
    blocks = (jm.ih, jm.hh)
    feats = (jm.in_features, jm.out_features)
    H4 = 4 * jm.out_features
    if not jm.resample_per_step:
        k_i, k_ib, k_h, k_hb = jax.random.split(base, 4)
        return dict(
            eps_w=(_normal(k_i, jm.ih.mu_weight.shape),
                   _normal(k_h, jm.hh.mu_weight.shape)),
            eps_b=(_normal(k_ib, (H4,)), _normal(k_hb, (H4,))))
    flip = jm.estimator == "flipout"
    dtype = jm.compute_dtype or jnp.float32
    out = {k: ([], []) for k in ("eps_w", "eps_b")
           + (("sign_in", "sign_out") if flip else ())}
    for t in range(T):
        keys = jax.random.split(jax.random.fold_in(base, t))
        for j, (key, lin) in enumerate(zip(keys, blocks)):
            shape = lin.mu_weight.shape
            if flip:
                k_eps, k_epsb, k_sin, k_sout = jax.random.split(key, 4)
                out["eps_w"][j].append(jax.random.normal(k_eps, shape,
                                                         dtype))
                out["eps_b"][j].append(jax.random.normal(k_epsb, (H4,),
                                                         dtype))
                out["sign_in"][j].append(
                    rademacher_fused(k_sin, (B, feats[j])))
                out["sign_out"][j].append(rademacher_fused(k_sout, (B, H4)))
            else:
                kw, kb = jax.random.split(key)
                out["eps_w"][j].append(_normal(kw, shape, dtype))
                out["eps_b"][j].append(_normal(kb, (H4,), dtype))
    return {k: tuple(jnp.stack(v) for v in pair) for k, pair in out.items()}


# --- the split-TF32 product of the fused sampled GEMM kernels (K-B, K-D) ---

TF32_MASK = -0x2000  # 0xFFFFE000 as int32: keeps sign, exponent, 10 bits


def tf32(a):
    """f32 tensor rounded to TF32 by clearing its 13 low mantissa bits, as
    the kernels do before a tensor-core product."""
    return (a.float().view(torch.int32) & TF32_MASK).view(torch.float32)


def split_tf32(a):
    """(hi, lo): hi = tf32(a), lo = tf32(a - hi); a - hi is exact in f32."""
    hi = tf32(a)
    return hi, tf32(a.float() - hi)


def tf32_matmul(a, b, terms=3):
    """a (M, K) @ b (N, K)^T as the kernels take it on the tensor cores,
    the sum in f64: ``terms=3`` is the split form hi*hi + hi*lo + lo*hi,
    ``terms=1`` one TF32 product hi*hi."""
    a_hi, a_lo = (t.double() for t in split_tf32(a))
    b_hi, b_lo = (t.double() for t in split_tf32(b))
    out = a_hi @ b_hi.T
    if terms == 3:
        out = out + a_hi @ b_lo.T + a_lo @ b_hi.T
    return out
