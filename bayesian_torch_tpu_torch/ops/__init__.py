"""Sampling, KL, linear and conv ops; hand-written kernels in ``cuda/``."""
