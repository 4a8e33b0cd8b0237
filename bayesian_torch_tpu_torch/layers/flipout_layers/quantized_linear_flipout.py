"""INT8 quantized Linear, Flipout (counterpart of
``bayesian_torch_tpu/layers/flipout_layers/quantized_linear_flipout.py``;
see ``layers/quantized_base.py``). The signs are drawn per call from the
counter hash, as the JAX layer draws them, not from the reference's
presampled sign pools."""

from bayesian_torch_tpu_torch.layers.quantized_base import (
    _QuantizedLinearBase,
)

__all__ = ["QuantizedLinearFlipout"]


class QuantizedLinearFlipout(_QuantizedLinearBase):
    estimator = "flipout"
