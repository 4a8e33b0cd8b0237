"""Post-training INT8 quantization API (mirrors
``bayesian_torch_tpu.ao.quantization``)."""

from bayesian_torch_tpu_torch.ao.quantization.quantize import (  # noqa: F401
    convert,
    enable_prepare,
    prepare,
)
