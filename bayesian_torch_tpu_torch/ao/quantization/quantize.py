"""Post-training INT8 quantization API (counterpart of
``bayesian_torch_tpu/ao/quantization/quantize.py``).

``prepare(model)`` inserts calibration observers into every Bayesian layer,
the user runs calibration batches through the prepared model, and
``convert(model)`` swaps in the INT8 quantized twins (``bnn_to_qbnn``).
The observers carry all the calibration state, so this works on any model
built from the port's Bayesian layers, not only ResNets.
"""

from __future__ import annotations

from torch import nn

# the layers and models are imported inside the functions: the layers'
# package imports the observers, whose package imports this module


def enable_prepare(m: nn.Module, qconfig=None) -> None:
    """Call ``prepare(qconfig)`` on every Bayesian layer not yet prepared
    (``qconfig``: an optional ``quantization.QConfig``)."""
    from bayesian_torch_tpu_torch.layers.base_variational_layer import (
        BaseVariationalLayer,
    )

    for mod in list(m.modules()):
        if isinstance(mod, BaseVariationalLayer) and hasattr(mod, "prepare") \
                and not mod.quant_prepare:
            mod.prepare(qconfig)


def prepare(model: nn.Module, qconfig=None) -> nn.Module:
    """Insert calibration observers; returns the same, mutated model. Run
    representative batches through it (an f32 forward that records the
    ranges), then call ``convert``."""
    enable_prepare(model, qconfig)
    return model


def convert(model: nn.Module, *, fuse_conv_bn: bool = False,
            quantize_activations: bool = False) -> nn.Module:
    """Swap the Bayesian layers for their INT8 twins using the ranges
    recorded since ``prepare``. ``quantize_activations=True`` keeps
    activations uint8 between convs (the ``QTensor`` flow)."""
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn

    bnn_to_qbnn(model, fuse_conv_bn=fuse_conv_bn,
                quantize_activations=quantize_activations)
    return model
