"""CIFAR ResNet-20..110 (Flipout) under the ``models.flipout`` namespace
(counterpart of ``bayesian_torch_tpu/models/flipout/resnet.py``)."""

from bayesian_torch_tpu_torch.models.bayesian.resnet_flipout import *  # noqa: F401,F403,E501
from bayesian_torch_tpu_torch.models.bayesian.resnet_flipout import __all__  # noqa: F401,E501
