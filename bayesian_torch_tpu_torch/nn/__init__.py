"""Tuple-threading containers, the MC-aware BatchNorms, the seeded
``Dropout2d``, the QTensor-aware pooling modules and functions and the
convs that take ``data_format``; everything else is ``torch.nn``."""

from bayesian_torch_tpu_torch.nn.modules import (  # noqa: F401
    AdaptiveAvgPool2d,
    BatchNorm1d,
    BatchNorm2d,
    BatchNorm3d,
    Conv1d,
    Conv2d,
    Conv3d,
    ConvTranspose1d,
    ConvTranspose2d,
    ConvTranspose3d,
    Dropout2d,
    MaxPool2d,
    Sequential,
)
