"""Post-training INT8 quantization API (mirrors
``bayesian_torch_tpu.quantization``): ``prepare`` / ``convert``, the
observers and the serving functions."""

from bayesian_torch_tpu_torch.quantization.quantize import (  # noqa: F401
    convert,
    enable_prepare,
    prepare,
)
from bayesian_torch_tpu_torch.quantization.observers import (  # noqa: F401
    HistogramObserver,
    MinMaxObserver,
    PerChannelMinMaxObserver,
    QConfig,
)
from bayesian_torch_tpu_torch.quantization.serving import (  # noqa: F401
    freeze_quantized_draws,
    unfreeze_quantized_draws,
)
