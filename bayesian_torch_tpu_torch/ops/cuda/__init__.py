"""Hand-written Hopper (sm_90a) kernels: the port of the JAX package's
Pallas kernels (``bayesian_torch_tpu/ops/pallas/``).

- ``sampled_weights.py``: K-A, the batch weight sampler (all S draws of
  every layer in one launch);
- ``sampled_matmul.py``: K-B, the fused sampled GEMM (the sampled weight
  never reaches device memory), and its backward K-D and K-E;
- ``qmatmul.py``: K-F, the fused int8 GEMM + requantize (the s32
  accumulator never reaches device memory);
- ``flipout_signs.py``: K-H, the Flipout signs hashed inside the products
  that use them (no Pallas counterpart: XLA fuses the JAX package's
  ``rademacher_fused`` into its consumer).

Each wrapper keeps its plain torch version beside it (taken for CPU
tensors only) and a ``launches`` count of kernel launches, registered
with ``utils.tracing.launch_counter``; under a profiler its route to the
launch is the span ``kernel.<wrapper>`` (``utils/tracing.py``). The CUDA
sources live in ``csrc/`` and are built by ``_build.py`` at first use.
"""

