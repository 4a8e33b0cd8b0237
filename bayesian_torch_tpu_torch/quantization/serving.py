"""Serving with frozen quantized draws (counterpart of
``bayesian_torch_tpu/quantization/serving.py``).

By default every forward of a quantized layer draws and builds a new int8
weight, as the reference does. ``freeze_quantized_draws`` draws one weight
per quantized layer and keeps it (buffers ``_frozen_w``, ``_frozen_wscale``,
``_frozen_bias``) until ``unfreeze_quantized_draws`` or the next freeze,
so repeated forwards skip the weight build: an opt-in deviation from
per-forward redraws. A reparameterization layer pins its whole weight, so
its forwards are deterministic; a Flipout layer pins its perturbation
``delta = sigma * eps`` and its perturbation bias, and its Rademacher
signs stay per call (Flipout's decorrelation; they are activation-sized
while the build is weight-sized).
"""

from __future__ import annotations

import torch
from torch import nn

from bayesian_torch_tpu_torch.layers.quantized_base import (
    FROZEN,
    NORMAL_SCALE,
    _QuantizedLayerBase,
)

__all__ = ["freeze_quantized_draws", "unfreeze_quantized_draws"]


def freeze_quantized_draws(model: nn.Module, *,
                           normal_scale: float = NORMAL_SCALE) -> int:
    """Draw and pin one quantized weight (Flipout: perturbation) per
    quantized layer; returns the number of layers frozen."""
    n = 0
    for mod in model.modules():
        if not isinstance(mod, _QuantizedLayerBase):
            continue
        if mod.estimator == "flipout":
            w_q, w_scale, bias = mod._sampled_qdelta_flipout(normal_scale)
        else:
            w_q, w_scale, bias = mod._sampled_qweight_reparam(normal_scale)
        mod.register_buffer("_frozen_w", w_q)
        mod.register_buffer("_frozen_wscale", torch.tensor(
            w_scale, dtype=torch.float32, device=w_q.device))
        mod.register_buffer("_frozen_bias", bias)
        mod._refresh_scales()
        n += 1
    return n


def unfreeze_quantized_draws(model: nn.Module) -> int:
    """Restore per-forward redraws; returns the number of layers
    unfrozen."""
    n = 0
    for mod in model.modules():
        if isinstance(mod, _QuantizedLayerBase) \
                and getattr(mod, "_frozen_w", None) is not None:
            for name in FROZEN:
                # a state carried from JAX holds no bias draw where the
                # layer has none
                if hasattr(mod, name):
                    delattr(mod, name)
            mod._refresh_scales()
            n += 1
    return n
