"""Bayesian ImageNet ResNet-18..152, Flipout (counterpart of
``bayesian_torch_tpu/models/bayesian/resnet_flipout_large.py``)."""

from bayesian_torch_tpu_torch.models._large_resnet import (  # noqa: F401
    BasicBlock,
    Bottleneck,
    LargeResNet,
    make_factories,
)

__all__ = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]

globals().update(make_factories("Flipout"))
