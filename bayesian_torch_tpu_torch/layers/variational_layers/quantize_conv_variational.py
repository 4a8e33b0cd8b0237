"""INT8 quantized convolutions, reparameterization (counterpart of
``quantize_conv_variational.py`` in
``bayesian_torch_tpu/layers/variational_layers/``; see
``layers/quantized_base.py``). The ConvTranspose classes come with the
grouped and transposed int8 convs (ROADMAP Queue 1 #14)."""

from bayesian_torch_tpu_torch.layers.quantized_base import _QuantizedConvBase

__all__ = [
    "QuantizedConv1dReparameterization",
    "QuantizedConv2dReparameterization",
    "QuantizedConv3dReparameterization",
]


class QuantizedConv1dReparameterization(_QuantizedConvBase):
    nd = 1


class QuantizedConv2dReparameterization(_QuantizedConvBase):
    nd = 2


class QuantizedConv3dReparameterization(_QuantizedConvBase):
    nd = 3
