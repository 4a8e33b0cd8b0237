"""Tuple-threading containers, the MC-aware BatchNorms, the seeded
``Dropout2d`` and the QTensor-aware pooling modules and functions;
everything else is ``torch.nn``."""

from bayesian_torch_tpu_torch.nn.modules import (  # noqa: F401
    AdaptiveAvgPool2d,
    BatchNorm1d,
    BatchNorm2d,
    BatchNorm3d,
    Dropout2d,
    MaxPool2d,
    Sequential,
)
