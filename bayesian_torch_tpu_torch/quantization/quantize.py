"""Public alias of the ao quantization API (mirrors
``bayesian_torch_tpu/quantization/quantize.py``)."""

from bayesian_torch_tpu_torch.ao.quantization.quantize import (  # noqa: F401
    convert,
    enable_prepare,
    prepare,
)
