"""Tuple-threading containers and the MC-aware ``BatchNorm2d``; everything
else is ``torch.nn``."""

from bayesian_torch_tpu_torch.nn.modules import BatchNorm2d, Sequential  # noqa: F401,E501
