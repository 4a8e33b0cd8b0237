"""Reparameterization-estimator layers."""

from bayesian_torch_tpu_torch.layers.variational_layers.conv_variational import (  # noqa: F401,E501
    Conv1dReparameterization,
    Conv2dReparameterization,
    Conv3dReparameterization,
    ConvTranspose1dReparameterization,
    ConvTranspose2dReparameterization,
    ConvTranspose3dReparameterization,
)
from bayesian_torch_tpu_torch.layers.variational_layers.linear_variational import (  # noqa: F401,E501
    LinearReparameterization,
)

__all__ = [
    "Conv1dReparameterization",
    "Conv2dReparameterization",
    "Conv3dReparameterization",
    "ConvTranspose1dReparameterization",
    "ConvTranspose2dReparameterization",
    "ConvTranspose3dReparameterization",
    "LinearReparameterization",
]
