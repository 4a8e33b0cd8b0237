"""Pooling and ReLU that take ``QTensor``s (counterpart of
``bayesian_torch_tpu/nn/functional.py``).

Max pooling runs on the quantized payload (max is monotonic in the
quantized domain, so it is exact): through an f16 copy, which holds 0-255
exactly, because torch's CUDA max pooling has no uint8 kernel. Average
pooling dequantizes first.

``data_format`` (JAX: "NCHW" or channels-last "NHWC"): a channels-last
input (B, *sp, C) is pooled through its (B, C, *sp) view, channels-last in
memory, and the result viewed back, with no copy of the activations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.ops.conv import from_nc, to_nc
from bayesian_torch_tpu_torch.ops.qtensor import (  # noqa: F401 (re-export)
    QTensor,
    dequantize_if_qtensor,
    relu,
)

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_ADAPTIVE_AVG_POOL = {1: F.adaptive_avg_pool1d, 2: F.adaptive_avg_pool2d,
                      3: F.adaptive_avg_pool3d}


def max_pool_nd(x, kernel_size, stride=None, padding=0, dilation=1,
                ceil_mode=False, *, data_format="NCHW"):
    """torch max_pool{1,2,3}d; a QTensor pools its uint8 payload."""
    args = (kernel_size, stride, padding, dilation, ceil_mode)
    if isinstance(x, QTensor):
        out = _MAX_POOL[x.ndim - 2](to_nc(x.q.half(), data_format), *args)
        return QTensor(from_nc(out, data_format).to(torch.uint8), x.scale,
                       x.zp)
    return from_nc(_MAX_POOL[x.dim() - 2](to_nc(x, data_format), *args),
                   data_format)


def avg_pool_nd(x, kernel_size, stride=None, padding=0,
                count_include_pad=True, *, data_format="NCHW"):
    """torch avg_pool{1,2,3}d of the dequantized input."""
    x = dequantize_if_qtensor(x)
    return from_nc(_AVG_POOL[x.dim() - 2](
        to_nc(x, data_format), kernel_size, stride, padding,
        count_include_pad=count_include_pad), data_format)


def adaptive_avg_pool_nd(x, output_size, *, data_format="NCHW"):
    """torch adaptive_avg_pool{1,2,3}d of the dequantized input."""
    x = dequantize_if_qtensor(x)
    return from_nc(_ADAPTIVE_AVG_POOL[x.dim() - 2](to_nc(x, data_format),
                                                   output_size),
                   data_format)
