"""KL collection over a model's Bayesian layers (counterpart of
``iter_bayesian_layers`` and ``get_kl_loss`` in
``bayesian_torch_tpu/models/dnn_to_bnn.py``; the ``dnn_to_bnn`` surgery
comes in a later slice)."""

from __future__ import annotations

from torch import nn

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    BaseVariationalLayer,
)


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
