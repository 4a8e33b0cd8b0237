"""Tuple-threading containers, the MC-aware ``BatchNorm2d`` and the
QTensor-aware pooling modules and functions; everything else is
``torch.nn``."""

from bayesian_torch_tpu_torch.nn.modules import (  # noqa: F401
    AdaptiveAvgPool2d,
    BatchNorm2d,
    MaxPool2d,
    Sequential,
)
