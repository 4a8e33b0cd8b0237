"""Reparameterization-estimator layers."""

from bayesian_torch_tpu_torch.layers.base_variational_layer import (  # noqa: F401,E501
    BaseVariationalLayer_,
)

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
from bayesian_torch_tpu_torch.layers.variational_layers.rnn_variational import (  # noqa: F401,E501
    LSTMReparameterization,
)
# the reference's subpackage also exports its quantized twins, and its
# quantized layer files leak the observer and QConfig names into it
from bayesian_torch_tpu_torch.layers.variational_layers.quantize_linear_variational import (  # noqa: F401,E501
    QuantizedLinearReparameterization,
)
from bayesian_torch_tpu_torch.layers.variational_layers.quantize_conv_variational import (  # noqa: F401,E501
    QuantizedConv1dReparameterization,
    QuantizedConv2dReparameterization,
    QuantizedConv3dReparameterization,
    QuantizedConvTranspose1dReparameterization,
    QuantizedConvTranspose2dReparameterization,
    QuantizedConvTranspose3dReparameterization,
)
from bayesian_torch_tpu_torch.quantization.observers import (  # noqa: F401,E501
    HistogramObserver,
    MinMaxObserver,
    PerChannelMinMaxObserver,
    QConfig,
)

__all__ = [
    "Conv1dReparameterization",
    "Conv2dReparameterization",
    "Conv3dReparameterization",
    "ConvTranspose1dReparameterization",
    "ConvTranspose2dReparameterization",
    "ConvTranspose3dReparameterization",
    "LinearReparameterization",
    "LSTMReparameterization",
]
