"""Conv layers with the Flipout estimator (counterpart of
``bayesian_torch_tpu/layers/flipout_layers/conv_flipout.py``). All three
share ``_BaseConvLayer``; the ConvTranspose classes come in a later slice
(ROADMAP Queue 1 #11)."""

from bayesian_torch_tpu_torch.layers.conv_base import _BaseConvLayer

__all__ = [
    "Conv1dFlipout",
    "Conv2dFlipout",
    "Conv3dFlipout",
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
