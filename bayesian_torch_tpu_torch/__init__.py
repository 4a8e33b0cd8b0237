"""bayesian_torch_tpu_torch: the PyTorch / CUDA (Hopper) port of
bayesian_torch_tpu.

The JAX package is the reference; this package mirrors its subpackage and
module names so each counterpart is found by path. It imports torch and
never jax. The kernels in ``csrc/`` are built with nvcc at their first
CUDA call (``ops/cuda/_build.py``); on CPU tensors every kernel wrapper
takes its plain torch version.
"""

from bayesian_torch_tpu_torch.quantization import convert, prepare  # noqa: F401,E402

__version__ = "0.1.0"
