"""Pooling and ReLU that take ``QTensor``s (counterpart of
``bayesian_torch_tpu/nn/functional.py``, NC* layout).

Max pooling runs on the quantized payload (max is monotonic in the
quantized domain, so it is exact): through an f16 copy, which holds 0-255
exactly, because torch's CUDA max pooling has no uint8 kernel. Average
pooling dequantizes first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
                ceil_mode=False):
    """torch max_pool{1,2,3}d; a QTensor pools its uint8 payload."""
    args = (kernel_size, stride, padding, dilation, ceil_mode)
    if isinstance(x, QTensor):
        out = _MAX_POOL[x.ndim - 2](x.q.half(), *args)
        return QTensor(out.to(torch.uint8), x.scale, x.zp)
    return _MAX_POOL[x.dim() - 2](x, *args)


def avg_pool_nd(x, kernel_size, stride=None, padding=0,
                count_include_pad=True):
    """torch avg_pool{1,2,3}d of the dequantized input."""
    x = dequantize_if_qtensor(x)
    return _AVG_POOL[x.dim() - 2](x, kernel_size, stride, padding,
                                  count_include_pad=count_include_pad)


def adaptive_avg_pool_nd(x, output_size):
    """torch adaptive_avg_pool{1,2,3}d of the dequantized input."""
    x = dequantize_if_qtensor(x)
    return _ADAPTIVE_AVG_POOL[x.dim() - 2](x, output_size)
