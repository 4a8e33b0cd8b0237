"""Legacy ``quantized_linear_flipout`` classes (counterpart of
``bayesian_torch_tpu/ao/nn/quantized/modules/quantized_linear_flipout.py``):
subclasses with ``legacy_ao = True`` (see the package docstring)."""

from bayesian_torch_tpu_torch.layers.flipout_layers import (
    quantized_linear_flipout as _base,
)

__all__ = [
    "QuantizedLinearFlipout",
]


class QuantizedLinearFlipout(_base.QuantizedLinearFlipout):
    legacy_ao = True
