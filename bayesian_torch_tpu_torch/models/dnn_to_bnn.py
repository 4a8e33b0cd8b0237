"""DNN -> BNN model surgery and KL collection (counterpart of
``bayesian_torch_tpu/models/dnn_to_bnn.py``).

``dnn_to_bnn`` walks a ``torch.nn`` module tree and replaces, in place,
every deterministic conv and linear layer with its Bayesian twin, driven
by the reference's ``bnn_prior_parameters`` dict:

    {
      "prior_mu": 0.0,
      "prior_sigma": 1.0,
      "posterior_mu_init": 0.0,
      "posterior_rho_init": -3.0,
      "type": "Reparameterization",  # or "Flipout"
      "moped_enable": False,
      "moped_delta": 0.5,
    }

As in the JAX package: recurse into a module with children first, skip a
module that is already Bayesian, then match by class name ("LSTM",
"Conv", "Linear"). Each twin returns bare outputs (``dnn_to_bnn_flag``),
so the model's own forward runs unchanged, and ``get_kl_loss`` collects
the KL. With ``moped_enable`` the posterior starts at mu = w, rho =
``get_rho(w, moped_delta)``; the priors stay scalar (``utils.MOPED`` sets
array priors).

A ``torch.nn.ConvTranspose{1,2,3}d`` becomes its ``ConvTranspose*`` twin
with its ``output_padding``; its weight keeps the (in, out // groups, *k)
layout, so MOPED copies it as it is. A ``torch.nn.LSTM`` or ``LSTMCell``
becomes the full-sequence ``LSTM*`` twin (single layer, one direction, no
projection, batch-first input; anything else is refused); MOPED does not apply to it, as in
the reference. The Bayesian convs pad with zeros only, so a conv with
another ``padding_mode`` is refused. A conv twin takes its deterministic
conv's ``data_format`` (the port's ``nn.Conv*`` carry one; a plain
``torch.nn`` conv is NCHW), as the JAX function does.
"""

from __future__ import annotations

import torch
from torch import nn

import bayesian_torch_tpu_torch.layers as bayesian_layers
from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    BaseVariationalLayer,
)
from bayesian_torch_tpu_torch.utils.util import get_rho


def _moped_init(bnn_layer, weight, bias, delta, kernel_attr):
    """MOPED empirical-Bayes init of the posterior: mu <- w, rho <-
    get_rho(w, delta)."""
    weight = weight.detach()
    bias = None if bias is None else bias.detach()
    getattr(bnn_layer, "mu_" + kernel_attr).copy_(weight)
    getattr(bnn_layer, "rho_" + kernel_attr).copy_(get_rho(weight, delta))
    if bnn_layer.mu_bias is not None and bias is not None:
        bnn_layer.mu_bias.copy_(bias)
        bnn_layer.rho_bias.copy_(get_rho(bias, delta))


def _twin_class(cls_name, params):
    name = cls_name + params["type"]
    twin = getattr(bayesian_layers, name, None)
    if twin is None:
        raise NotImplementedError(
            f"dnn_to_bnn: {cls_name} has no Bayesian twin {name} in the "
            "port")
    return twin


def _finish(bnn_layer, params, weight, bias, kernel_attr):
    if params.get("moped_enable", False):
        with torch.no_grad():
            _moped_init(bnn_layer, weight, bias, params["moped_delta"],
                        kernel_attr)
    bnn_layer.dnn_to_bnn_flag = True
    return bnn_layer


def _prior_kwargs(params):
    return dict(prior_mean=params["prior_mu"],
                prior_variance=params["prior_sigma"],
                posterior_mu_init=params["posterior_mu_init"],
                posterior_rho_init=params["posterior_rho_init"])


def bnn_linear_layer(params, d):
    """The Bayesian twin of a deterministic linear layer ``d``, on its
    device."""
    has_bias = d.bias is not None
    bnn_layer = _twin_class(type(d).__name__, params)(
        in_features=d.in_features, out_features=d.out_features,
        bias=has_bias, device=d.weight.device, **_prior_kwargs(params))
    return _finish(bnn_layer, params, d.weight, d.bias, "weight")


def bnn_conv_layer(params, d):
    """The Bayesian twin of a deterministic ``torch.nn.Conv{1,2,3}d`` or
    ``ConvTranspose{1,2,3}d`` ``d``, with its geometry (string padding
    passed on as it is; a transposed conv's ``output_padding``), on its
    device."""
    cls_name = type(d).__name__
    if getattr(d, "padding_mode", "zeros") != "zeros":
        raise ValueError(
            f"dnn_to_bnn: {cls_name} with padding_mode={d.padding_mode!r}: "
            "the Bayesian convs pad with zeros only")
    bnn_layer = _twin_class(cls_name, params)(
        in_channels=d.in_channels, out_channels=d.out_channels,
        kernel_size=d.kernel_size, stride=d.stride, padding=d.padding,
        dilation=d.dilation, groups=d.groups, bias=d.bias is not None,
        output_padding=getattr(d, "output_padding", 0),
        data_format=getattr(d, "data_format", "NCHW"),
        device=d.weight.device, **_prior_kwargs(params))
    return _finish(bnn_layer, params, d.weight, d.bias, "kernel")


def bnn_lstm_layer(params, d):
    """The Bayesian full-sequence LSTM twin of a ``torch.nn.LSTM`` or
    ``LSTMCell`` ``d`` (geometry from ``input_size``, ``hidden_size`` and
    ``bias``), on its device. A twin is one layer in one direction that
    reads (B, T, in): more layers, ``bidirectional``, a projection or an
    ``nn.LSTM`` with ``batch_first=False`` (torch's default, (T, B, in))
    raise ``ValueError``. MOPED
    is not supported for LSTMs: with it enabled the twin keeps its random
    initialisation, with the reference's warning."""
    cls_name = type(d).__name__
    for attr, plain in (("num_layers", 1), ("bidirectional", False),
                        ("proj_size", 0), ("batch_first", True)):
        value = getattr(d, attr, plain)
        if value != plain:
            raise ValueError(
                f"dnn_to_bnn: {cls_name} with {attr}={value!r}: the Bayesian "
                f"LSTM twin has {attr}={plain!r}")
    bnn_layer = _twin_class("LSTM", params)(
        in_features=d.input_size, out_features=d.hidden_size,
        bias=bool(d.bias), device=next(d.parameters()).device,
        **_prior_kwargs(params))
    if params.get("moped_enable", False):
        print("WARNING: MOPED method is not supported for LSTM layers!!!")
    bnn_layer.dnn_to_bnn_flag = True
    return bnn_layer


def dnn_to_bnn(m: nn.Module, bnn_prior_parameters: dict) -> None:
    """In-place surgery: recurse the module tree and swap any submodule
    whose class name contains LSTM, Conv or Linear for its Bayesian twin.
    Returns None."""
    for name, value in list(m.named_children()):
        if isinstance(value, BaseVariationalLayer):
            continue  # already Bayesian
        cls_name = type(value).__name__
        if "LSTM" in cls_name:
            setattr(m, name, bnn_lstm_layer(bnn_prior_parameters, value))
        elif next(value.children(), None) is not None:
            dnn_to_bnn(value, bnn_prior_parameters)
        elif "Conv" in cls_name:
            setattr(m, name, bnn_conv_layer(bnn_prior_parameters, value))
        elif "Linear" in cls_name:
            setattr(m, name, bnn_linear_layer(bnn_prior_parameters, value))
    return None


def iter_bayesian_layers(m: nn.Module):
    """Yield every Bayesian layer once, in registration order, without
    descending into a Bayesian layer's own children."""
    seen = set()

    def _walk(mod):
        if id(mod) in seen:
            return
        seen.add(id(mod))
        if isinstance(mod, BaseVariationalLayer):
            yield mod
            return
        for child in mod.children():
            yield from _walk(child)

    yield from _walk(m)


def get_kl_loss(m: nn.Module):
    """Sum of the per-layer KL over all Bayesian layers (None if none)."""
    kl_loss = None
    for layer in iter_bayesian_layers(m):
        kl = layer.kl_loss()
        kl_loss = kl if kl_loss is None else kl_loss + kl
    return kl_loss
