"""Legacy ``quantized_conv_flipout`` classes (counterpart of
``bayesian_torch_tpu/ao/nn/quantized/modules/quantized_conv_flipout.py``):
subclasses with ``legacy_ao = True`` (see the package docstring)."""

from bayesian_torch_tpu_torch.layers.flipout_layers import (
    quantized_conv_flipout as _base,
)

__all__ = [
    "QuantizedConv1dFlipout",
    "QuantizedConv2dFlipout",
    "QuantizedConv3dFlipout",
    "QuantizedConvTranspose1dFlipout",
    "QuantizedConvTranspose2dFlipout",
    "QuantizedConvTranspose3dFlipout",
]


class QuantizedConv1dFlipout(_base.QuantizedConv1dFlipout):
    legacy_ao = True


class QuantizedConv2dFlipout(_base.QuantizedConv2dFlipout):
    legacy_ao = True


class QuantizedConv3dFlipout(_base.QuantizedConv3dFlipout):
    legacy_ao = True


class QuantizedConvTranspose1dFlipout(_base.QuantizedConvTranspose1dFlipout):
    legacy_ao = True


class QuantizedConvTranspose2dFlipout(_base.QuantizedConvTranspose2dFlipout):
    legacy_ao = True


class QuantizedConvTranspose3dFlipout(_base.QuantizedConvTranspose3dFlipout):
    legacy_ao = True
