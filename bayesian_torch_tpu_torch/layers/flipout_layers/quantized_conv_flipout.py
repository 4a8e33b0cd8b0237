"""INT8 quantized Conv / ConvTranspose, Flipout (counterpart of
``bayesian_torch_tpu/layers/flipout_layers/quantized_conv_flipout.py``;
see ``layers/quantized_base.py``)."""

from bayesian_torch_tpu_torch.layers.quantized_base import _QuantizedConvBase

__all__ = [
    "QuantizedConv1dFlipout",
    "QuantizedConv2dFlipout",
    "QuantizedConv3dFlipout",
    "QuantizedConvTranspose1dFlipout",
    "QuantizedConvTranspose2dFlipout",
    "QuantizedConvTranspose3dFlipout",
]


class QuantizedConv1dFlipout(_QuantizedConvBase):
    estimator = "flipout"
    nd = 1


class QuantizedConv2dFlipout(_QuantizedConvBase):
    estimator = "flipout"
    nd = 2


class QuantizedConv3dFlipout(_QuantizedConvBase):
    estimator = "flipout"
    nd = 3


class QuantizedConvTranspose1dFlipout(_QuantizedConvBase):
    estimator = "flipout"
    nd = 1
    transposed = True


class QuantizedConvTranspose2dFlipout(_QuantizedConvBase):
    estimator = "flipout"
    nd = 2
    transposed = True


class QuantizedConvTranspose3dFlipout(_QuantizedConvBase):
    estimator = "flipout"
    nd = 3
    transposed = True
