"""Conv and ConvTranspose layers with the reparameterization estimator
(counterpart of
``bayesian_torch_tpu/layers/variational_layers/conv_variational.py``).
All six share ``_BaseConvLayer``."""

from bayesian_torch_tpu_torch.layers.conv_base import _BaseConvLayer

__all__ = [
    "Conv1dReparameterization",
    "Conv2dReparameterization",
    "Conv3dReparameterization",
    "ConvTranspose1dReparameterization",
    "ConvTranspose2dReparameterization",
    "ConvTranspose3dReparameterization",
]


class Conv1dReparameterization(_BaseConvLayer):
    nd = 1


class Conv2dReparameterization(_BaseConvLayer):
    nd = 2


class Conv3dReparameterization(_BaseConvLayer):
    nd = 3


class ConvTranspose1dReparameterization(_BaseConvLayer):
    nd = 1
    transposed = True


class ConvTranspose2dReparameterization(_BaseConvLayer):
    nd = 2
    transposed = True


class ConvTranspose3dReparameterization(_BaseConvLayer):
    nd = 3
    transposed = True
