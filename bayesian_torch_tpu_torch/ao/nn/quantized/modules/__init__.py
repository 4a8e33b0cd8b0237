"""The reference's legacy quantized layers (counterpart of
``bayesian_torch_tpu/ao/nn/quantized/modules``): real subclasses of the
quantized layers of ``bayesian_torch_tpu_torch.layers`` that pin
``legacy_ao = True``: the default scale is 0.1 (0.2 elsewhere),
``quantize()`` takes the bias through an int8 round trip, and there is no
calibrated ``quant_dict`` path."""

from bayesian_torch_tpu_torch.ao.nn.quantized.modules.quantize_linear_variational import *  # noqa: F401,F403,E501
from bayesian_torch_tpu_torch.ao.nn.quantized.modules.quantize_conv_variational import *  # noqa: F401,F403,E501
from bayesian_torch_tpu_torch.ao.nn.quantized.modules.quantized_linear_flipout import *  # noqa: F401,F403,E501
from bayesian_torch_tpu_torch.ao.nn.quantized.modules.quantized_conv_flipout import *  # noqa: F401,F403,E501
