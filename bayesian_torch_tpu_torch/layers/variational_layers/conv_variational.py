"""Conv layers with the reparameterization estimator (counterpart of
``bayesian_torch_tpu/layers/variational_layers/conv_variational.py``).
All three share ``_BaseConvLayer``; the ConvTranspose classes come in a
later slice (ROADMAP Queue 1)."""

from bayesian_torch_tpu_torch.layers.conv_base import _BaseConvLayer

__all__ = [
    "Conv1dReparameterization",
    "Conv2dReparameterization",
    "Conv3dReparameterization",
]


class Conv1dReparameterization(_BaseConvLayer):
    nd = 1


class Conv2dReparameterization(_BaseConvLayer):
    nd = 2


class Conv3dReparameterization(_BaseConvLayer):
    nd = 3
