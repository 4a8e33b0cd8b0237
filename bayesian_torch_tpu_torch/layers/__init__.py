"""Bayesian layer classes ported so far, re-exported flat (mirrors
``bayesian_torch_tpu.layers``), with the INT8 quantized twins."""

from bayesian_torch_tpu_torch.layers.base_variational_layer import (  # noqa: F401,E501
    BaseVariationalLayer,
    BaseVariationalLayer_,
    get_kernel_size,
    seed_default_generator,
)
from bayesian_torch_tpu_torch.layers.batchnorm import (  # noqa: F401
    BatchNorm1dLayer,
    BatchNorm2dLayer,
    BatchNorm3dLayer,
)
from bayesian_torch_tpu_torch.layers.dropout import Dropout  # noqa: F401
from bayesian_torch_tpu_torch.layers.relu import ReLU  # noqa: F401
from bayesian_torch_tpu_torch.layers.variational_layers import *  # noqa: F401,F403,E501
from bayesian_torch_tpu_torch.layers.flipout_layers import *  # noqa: F401,F403,E501
from bayesian_torch_tpu_torch.layers.variational_layers.quantize_linear_variational import (  # noqa: F401,E501
    QuantizedLinearReparameterization,
)
from bayesian_torch_tpu_torch.layers.variational_layers.quantize_conv_variational import (  # noqa: F401,E501
    QuantizedConv1dReparameterization,
    QuantizedConv2dReparameterization,
    QuantizedConv3dReparameterization,
)
