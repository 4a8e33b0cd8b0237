"""Conv and ConvTranspose layers with the Flipout estimator
(counterpart of
``bayesian_torch_tpu/layers/flipout_layers/conv_flipout.py``).
All six share ``_BaseConvLayer``."""

from bayesian_torch_tpu_torch.layers.conv_base import _BaseConvLayer

__all__ = [
    "Conv1dFlipout",
    "Conv2dFlipout",
    "Conv3dFlipout",
    "ConvTranspose1dFlipout",
    "ConvTranspose2dFlipout",
    "ConvTranspose3dFlipout",
]


class Conv1dFlipout(_BaseConvLayer):
    nd = 1
    estimator = "flipout"


class Conv2dFlipout(_BaseConvLayer):
    nd = 2
    estimator = "flipout"


class Conv3dFlipout(_BaseConvLayer):
    nd = 3
    estimator = "flipout"


class ConvTranspose1dFlipout(_BaseConvLayer):
    nd = 1
    transposed = True
    estimator = "flipout"


class ConvTranspose2dFlipout(_BaseConvLayer):
    nd = 2
    transposed = True
    estimator = "flipout"


class ConvTranspose3dFlipout(_BaseConvLayer):
    nd = 3
    transposed = True
    estimator = "flipout"
