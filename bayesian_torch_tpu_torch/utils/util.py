"""Uncertainty metrics, the inverse softplus ``get_rho``, MOPED and
``freeze_batchnorm`` (counterpart of ``bayesian_torch_tpu/utils/util.py``).

The entropy metrics take numpy in and give numpy out (CPU tensors are
accepted as arrays). ``get_rho`` maps a torch tensor to a torch tensor on
its device. ``MOPED`` and ``freeze_batchnorm`` change a model in place.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def entropy(prob):
    """-sum p log p along the last axis."""
    prob = np.asarray(prob)
    return -1 * np.sum(prob * np.log(prob + 1e-15), axis=-1)


def predictive_entropy(mc_preds):
    """Entropy of the MC-mean predictive distribution; mc_preds of shape
    (MC, N, classes)."""
    return entropy(np.mean(np.asarray(mc_preds), axis=0))


def mutual_information(mc_preds):
    """Predictive entropy minus the mean per-draw entropy."""
    mc_preds = np.asarray(mc_preds)
    return entropy(np.mean(mc_preds, axis=0)) - np.mean(entropy(mc_preds),
                                                        axis=0)


def get_rho(sigma, delta):
    """Inverse softplus: rho with softplus(rho) = delta * |sigma|, as
    ``log(expm1(delta * |sigma|) + 1e-20)``. ``expm1`` keeps the digits
    of a small ``delta * |sigma|`` that ``exp(x) - 1`` would lose."""
    sigma = torch.as_tensor(sigma)
    return torch.log(torch.expm1(delta * sigma.abs()) + 1e-20)


def _moped_kind(mod):
    """"conv", "linear" or "bn" for a module MOPED writes, else None."""
    # the layers import this package (``utils.tracing``): imported here
    from bayesian_torch_tpu_torch.layers import (LinearFlipout,
                                                 LinearReparameterization)
    from bayesian_torch_tpu_torch.layers.conv_base import _BaseConvLayer

    if isinstance(mod, _BaseConvLayer):  # Conv{1,2,3}d, both estimators
        return "conv"
    if isinstance(mod, (LinearReparameterization, LinearFlipout)):
        return "linear"
    if isinstance(mod, nn.modules.batchnorm._BatchNorm):
        return "bn"
    return None


_DET_KIND = {"conv": nn.modules.conv._ConvNd, "linear": nn.Linear,
             "bn": nn.modules.batchnorm._BatchNorm}


def _set_prior_and_posterior(layer, mu_name, rho_name, det, delta):
    """Prior means become the full arrays of ``det``'s weight and bias;
    the posterior starts at mu = w, rho = get_rho(w, delta)."""
    mu = getattr(layer, mu_name)
    if tuple(det.weight.shape) != tuple(mu.shape):
        raise ValueError(
            f"MOPED: {type(layer).__name__} weight {tuple(mu.shape)} paired "
            f"with {type(det).__name__} weight {tuple(det.weight.shape)}")
    if layer.mu_bias is not None and det.bias is None:
        raise ValueError(f"MOPED: {type(layer).__name__} has a bias, its "
                         f"{type(det).__name__} has none")

    def like(t, ref):
        return t.detach().to(device=ref.device, dtype=ref.dtype).clone()

    w = like(det.weight, mu)
    # the prior buffers change shape (scalar -> array): assigning to a
    # registered buffer keeps it non-persistent
    layer.prior_weight_mu = w.clone()
    mu.copy_(w)
    getattr(layer, rho_name).copy_(get_rho(w, delta))
    if layer.mu_bias is not None:
        b = like(det.bias, layer.mu_bias)
        layer.prior_bias_mu = b.clone()
        layer.mu_bias.copy_(b)
        layer.rho_bias.copy_(get_rho(b, delta))


def MOPED(model: nn.Module, det_model: nn.Module, det_checkpoint,
          delta: float):
    """Model Priors with Empirical Bayes using a Deterministic DNN
    (Krishnan et al., AAAI 2020), in place; returns ``model``.

    Pairs ``model.modules()`` with ``det_model.modules()`` (registration
    order in both) and, by the Bayesian module's class: a conv or linear
    Bayesian layer (either estimator) takes its prior means as the full
    arrays of the paired ``torch.nn`` layer's weight and bias and starts
    its posterior at mu = w, rho = ``get_rho(w, delta)``; a BatchNorm
    takes the paired BatchNorm's affine parameters, running statistics and
    ``num_batches_tracked``. A pair of the wrong kind or of other weight
    shapes raises ``ValueError``. ``det_checkpoint`` is a
    ``utils.checkpoint.save_checkpoint`` file loaded into ``det_model``
    first, or None to use ``det_model`` as it is.

    Checkpoints keep no prior, so a resumed run applies MOPED before it
    loads its checkpoint.
    """
    if det_checkpoint is not None:
        from bayesian_torch_tpu_torch.utils.checkpoint import load_checkpoint
        load_checkpoint(det_model, det_checkpoint)

    mods, det_mods = list(model.modules()), list(det_model.modules())
    if len(mods) != len(det_mods):
        raise ValueError(f"MOPED: the model has {len(mods)} modules, the "
                         f"deterministic model {len(det_mods)}")
    with torch.no_grad():
        for i, (layer, det) in enumerate(zip(mods, det_mods)):
            kind = _moped_kind(layer)
            if kind is None:
                continue
            if not isinstance(det, _DET_KIND[kind]):
                raise ValueError(
                    f"MOPED: module {i} is a {type(layer).__name__}, its "
                    f"pair in the deterministic model a {type(det).__name__}")
            if kind == "conv":
                _set_prior_and_posterior(layer, "mu_kernel", "rho_kernel",
                                         det, delta)
            elif kind == "linear":
                _set_prior_and_posterior(layer, "mu_weight", "rho_weight",
                                         det, delta)
            else:
                for name in ("weight", "bias", "running_mean", "running_var",
                             "num_batches_tracked"):
                    dst = getattr(layer, name)
                    if dst is not None:
                        dst.copy_(getattr(det, name))
    return model


def freeze_batchnorm(model: nn.Module) -> int:
    """Put every BatchNorm layer into eval mode while the rest of the
    model keeps training: normalisation then uses the running statistics,
    which no training-mode forward updates. Returns the number of layers
    frozen; ``model.train()`` undoes it."""
    n = 0
    for mod in model.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm) \
                and mod.running_mean is not None:
            mod.training = False
            n += 1
    return n
