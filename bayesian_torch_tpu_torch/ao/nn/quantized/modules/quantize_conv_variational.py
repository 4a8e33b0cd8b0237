"""Legacy ``quantize_conv_variational`` classes (counterpart of
``bayesian_torch_tpu/ao/nn/quantized/modules/quantize_conv_variational.py``):
subclasses with ``legacy_ao = True`` (see the package docstring)."""

from bayesian_torch_tpu_torch.layers.variational_layers import (
    quantize_conv_variational as _base,
)

__all__ = [
    "QuantizedConv1dReparameterization",
    "QuantizedConv2dReparameterization",
    "QuantizedConv3dReparameterization",
    "QuantizedConvTranspose1dReparameterization",
    "QuantizedConvTranspose2dReparameterization",
    "QuantizedConvTranspose3dReparameterization",
]


class QuantizedConv1dReparameterization(
        _base.QuantizedConv1dReparameterization):
    legacy_ao = True


class QuantizedConv2dReparameterization(
        _base.QuantizedConv2dReparameterization):
    legacy_ao = True


class QuantizedConv3dReparameterization(
        _base.QuantizedConv3dReparameterization):
    legacy_ao = True


class QuantizedConvTranspose1dReparameterization(
        _base.QuantizedConvTranspose1dReparameterization):
    legacy_ao = True


class QuantizedConvTranspose2dReparameterization(
        _base.QuantizedConvTranspose2dReparameterization):
    legacy_ao = True


class QuantizedConvTranspose3dReparameterization(
        _base.QuantizedConvTranspose3dReparameterization):
    legacy_ao = True
