"""``Sequential`` that threads (x, kl) tuples, the MC-aware BatchNorms,
the seeded channel dropout ``Dropout2d``, pooling modules that take
``QTensor``s, and the deterministic convs with ``data_format``
(counterparts of those of ``bayesian_torch_tpu/nn/modules.py``; the other
modules there are twins of ``torch.nn``, which the port uses directly).

``Conv1d/2d/3d`` and ``ConvTranspose1d/2d/3d`` are ``torch.nn``'s classes
(the same parameters, ``state_dict`` keys and initialisation) that also
take ``data_format``: under "NCHW" the forward is torch's own; under a
channels-last format (JAX: "NHWC") it takes and returns (B, *sp, C)
through ``ops.conv.conv_nd`` / ``conv_transpose_nd``. As in JAX a
deterministic conv sets ``pointwise_dot = True``, so under NHWC a 1x1
stride-1 conv is a GEMM over the channel axis (K-G channels-last on the
card); set it to None to follow ``ops.conv.CONV_1X1_DOT``, or False.
"""

from torch import nn

from bayesian_torch_tpu_torch.layers.batchnorm import (  # noqa: F401
    BatchNorm1d,
    BatchNorm2d,
    BatchNorm3d,
)
from bayesian_torch_tpu_torch.layers.dropout import Dropout2d  # noqa: F401
from bayesian_torch_tpu_torch.nn import functional as F
from bayesian_torch_tpu_torch.ops import conv as conv_ops


class Sequential(nn.Sequential):
    """If a child returns an ``(x, kl)`` pair, its kl is accumulated and
    the pair is re-formed at the end, so a Bayesian downsample path
    ``Sequential(conv, BatchNorm2dLayer)`` returns the conv's KL."""

    def forward(self, x):
        kl_total = None
        for mod in self:
            out = mod(x)
            if isinstance(out, tuple) and len(out) == 2:
                x, kl = out
                kl_total = kl if kl_total is None else kl_total + kl
            else:
                x = out
        if kl_total is not None:
            return x, kl_total
        return x


class MaxPool2d(nn.MaxPool2d):
    """``torch.nn.MaxPool2d`` that pools a QTensor in uint8, on NCHW or
    channels-last activations."""

    def __init__(self, *args, data_format: str = "NCHW", **kwargs):
        super().__init__(*args, **kwargs)
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool_nd(x, self.kernel_size, self.stride, self.padding,
                             self.dilation, self.ceil_mode,
                             data_format=self.data_format)


class AdaptiveAvgPool2d(nn.AdaptiveAvgPool2d):
    """``torch.nn.AdaptiveAvgPool2d`` that dequantizes a QTensor, on NCHW
    or channels-last activations."""

    def __init__(self, *args, data_format: str = "NCHW", **kwargs):
        super().__init__(*args, **kwargs)
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool_nd(x, self.output_size,
                                      data_format=self.data_format)


class _ConvNd:
    """``data_format`` and ``pointwise_dot`` over a ``torch.nn`` conv."""

    def __init__(self, *args, data_format: str = "NCHW", device=None,
                 **kwargs):
        # ``device`` named, as ``torch.nn.utils.skip_init`` wants it
        super().__init__(*args, device=device, **kwargs)
        self.data_format = data_format
        self.pointwise_dot = True

    def forward(self, x, *args):
        if not conv_ops.channels_last(self.data_format):
            return super().forward(x, *args)
        if self.padding_mode != "zeros":
            raise NotImplementedError(
                f"{type(self).__name__}(data_format={self.data_format!r}) "
                f"with padding_mode={self.padding_mode!r}: channels-last "
                "convs pad with zeros only")
        if self.transposed:
            return conv_ops.conv_transpose_nd(
                x, self.weight, self.bias, stride=self.stride,
                padding=self.padding, output_padding=self.output_padding,
                dilation=self.dilation, groups=self.groups,
                data_format=self.data_format)
        return conv_ops.conv_nd(
            x, self.weight, self.bias, stride=self.stride,
            padding=self.padding, dilation=self.dilation,
            groups=self.groups, data_format=self.data_format,
            pointwise_dot=self.pointwise_dot)


class Conv1d(_ConvNd, nn.Conv1d):
    pass


class Conv2d(_ConvNd, nn.Conv2d):
    pass


class Conv3d(_ConvNd, nn.Conv3d):
    pass


class ConvTranspose1d(_ConvNd, nn.ConvTranspose1d):
    pass


class ConvTranspose2d(_ConvNd, nn.ConvTranspose2d):
    pass


class ConvTranspose3d(_ConvNd, nn.ConvTranspose3d):
    pass
