"""Sampling, KL, linear and conv ops; hand-written kernels in ``cuda/``."""

from bayesian_torch_tpu_torch.ops.kl import gaussian_kl  # noqa: F401
from bayesian_torch_tpu_torch.ops.sampling import (  # noqa: F401
    sample_gaussian_weight,
    sigma_from_rho,
)
