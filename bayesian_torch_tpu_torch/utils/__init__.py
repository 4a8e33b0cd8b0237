"""Weight transfer from the JAX package."""

from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state  # noqa: F401,E501
