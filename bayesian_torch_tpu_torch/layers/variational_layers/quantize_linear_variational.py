"""INT8 quantized Linear, reparameterization (counterpart of
``quantize_linear_variational.py`` in
``bayesian_torch_tpu/layers/variational_layers/``; see
``layers/quantized_base.py``)."""

from bayesian_torch_tpu_torch.layers.quantized_base import (
    _QuantizedLinearBase,
)

__all__ = ["QuantizedLinearReparameterization"]


class QuantizedLinearReparameterization(_QuantizedLinearBase):
    pass
