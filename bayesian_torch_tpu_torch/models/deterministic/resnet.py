"""Deterministic CIFAR ResNet-20..110, the MOPED source and the
``dnn_to_bnn`` input (counterpart of
``bayesian_torch_tpu/models/deterministic/resnet.py``)."""

from bayesian_torch_tpu_torch.models._cifar_resnet import (  # noqa: F401
    BasicBlock,
    CifarResNet,
    make_factories,
)

__all__ = ["resnet20", "resnet32", "resnet44", "resnet56", "resnet110"]

globals().update(make_factories(None))
