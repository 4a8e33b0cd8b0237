"""``Sequential`` that threads (x, kl) tuples, the MC-aware BatchNorms,
the seeded channel dropout ``Dropout2d`` and pooling modules that take
``QTensor``s (counterparts of those of ``bayesian_torch_tpu/nn/modules.py``;
the other modules there are twins of ``torch.nn``, which the port uses
directly)."""

from torch import nn

from bayesian_torch_tpu_torch.layers.batchnorm import (  # noqa: F401
    BatchNorm1d,
    BatchNorm2d,
    BatchNorm3d,
)
from bayesian_torch_tpu_torch.layers.dropout import Dropout2d  # noqa: F401
from bayesian_torch_tpu_torch.nn import functional as F


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
    """``torch.nn.MaxPool2d`` that pools a QTensor in uint8."""

    def forward(self, x):
        return F.max_pool_nd(x, self.kernel_size, self.stride, self.padding,
                             self.dilation, self.ceil_mode)


class AdaptiveAvgPool2d(nn.AdaptiveAvgPool2d):
    """``torch.nn.AdaptiveAvgPool2d`` that dequantizes a QTensor."""

    def forward(self, x):
        return F.adaptive_avg_pool_nd(x, self.output_size)
