"""Bayesian CIFAR ResNet-20..110, reparameterization
(counterpart of
``bayesian_torch_tpu/models/bayesian/resnet_variational.py``)."""

from bayesian_torch_tpu_torch.models._cifar_resnet import (  # noqa: F401
    BasicBlock,
    CifarResNet,
    make_factories,
)

__all__ = ["resnet20", "resnet32", "resnet44", "resnet56", "resnet110"]

globals().update(make_factories("Reparameterization"))
