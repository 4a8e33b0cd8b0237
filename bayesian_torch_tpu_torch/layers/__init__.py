"""Bayesian layer classes, re-exported flat (mirrors
``bayesian_torch_tpu.layers``), with the INT8 quantized twins of both
estimators and the calibration observers."""

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
    QuantizedBatchNorm2d,
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
    QuantizedConvTranspose1dReparameterization,
    QuantizedConvTranspose2dReparameterization,
    QuantizedConvTranspose3dReparameterization,
)
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
# the reference's layer files pull the observer and QConfig names into
# bayesian_torch.layers
from bayesian_torch_tpu_torch.quantization.observers import (  # noqa: F401,E402,E501
    HistogramObserver,
    MinMaxObserver,
    PerChannelMinMaxObserver,
    QConfig,
)
