"""Flipout-estimator layers."""

from bayesian_torch_tpu_torch.layers.base_variational_layer import (  # noqa: F401,E501
    BaseVariationalLayer_,
)
from bayesian_torch_tpu_torch.layers.flipout_layers.conv_flipout import (  # noqa: F401,E501
    Conv1dFlipout,
    Conv2dFlipout,
    Conv3dFlipout,
    ConvTranspose1dFlipout,
    ConvTranspose2dFlipout,
    ConvTranspose3dFlipout,
)
from bayesian_torch_tpu_torch.layers.flipout_layers.linear_flipout import (  # noqa: F401,E501
    LinearFlipout,
)
from bayesian_torch_tpu_torch.layers.flipout_layers.rnn_flipout import (  # noqa: F401,E501
    LSTMFlipout,
)
# the reference's subpackage also exports its quantized twins
from bayesian_torch_tpu_torch.layers.flipout_layers.quantized_linear_flipout import (  # noqa: F401,E501
    QuantizedLinearFlipout,
)
from bayesian_torch_tpu_torch.layers.flipout_layers.quantized_conv_flipout import (  # noqa: F401,E501
    QuantizedConv1dFlipout,
    QuantizedConv2dFlipout,
    QuantizedConv3dFlipout,
    QuantizedConvTranspose1dFlipout,
    QuantizedConvTranspose2dFlipout,
    QuantizedConvTranspose3dFlipout,
)

__all__ = [
    "Conv1dFlipout",
    "Conv2dFlipout",
    "Conv3dFlipout",
    "ConvTranspose1dFlipout",
    "ConvTranspose2dFlipout",
    "ConvTranspose3dFlipout",
    "LinearFlipout",
    "LSTMFlipout",
]
