"""INT8 quantized Conv / ConvTranspose, reparameterization (counterpart
of ``quantize_conv_variational.py`` in
``bayesian_torch_tpu/layers/variational_layers/``; see
``layers/quantized_base.py``)."""

from bayesian_torch_tpu_torch.layers.quantized_base import _QuantizedConvBase

__all__ = [
    "QuantizedConv1dReparameterization",
    "QuantizedConv2dReparameterization",
    "QuantizedConv3dReparameterization",
    "QuantizedConvTranspose1dReparameterization",
    "QuantizedConvTranspose2dReparameterization",
    "QuantizedConvTranspose3dReparameterization",
]


class QuantizedConv1dReparameterization(_QuantizedConvBase):
    nd = 1


class QuantizedConv2dReparameterization(_QuantizedConvBase):
    nd = 2


class QuantizedConv3dReparameterization(_QuantizedConvBase):
    nd = 3


class QuantizedConvTranspose1dReparameterization(_QuantizedConvBase):
    nd = 1
    transposed = True


class QuantizedConvTranspose2dReparameterization(_QuantizedConvBase):
    nd = 2
    transposed = True


class QuantizedConvTranspose3dReparameterization(_QuantizedConvBase):
    nd = 3
    transposed = True
