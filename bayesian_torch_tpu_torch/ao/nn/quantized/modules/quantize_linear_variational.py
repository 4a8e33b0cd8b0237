"""Legacy ``quantize_linear_variational`` classes (counterpart of
``bayesian_torch_tpu/ao/nn/quantized/modules/quantize_linear_variational.py``):
subclasses with ``legacy_ao = True`` (see the package docstring)."""

from bayesian_torch_tpu_torch.layers.variational_layers import (
    quantize_linear_variational as _base,
)

__all__ = [
    "QuantizedLinearReparameterization",
]


class QuantizedLinearReparameterization(
        _base.QuantizedLinearReparameterization):
    legacy_ao = True
