"""Checkpoints, weight transfer from the JAX package, and the uncertainty
metrics."""

from bayesian_torch_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    load_jax_quant_state,
    load_jax_state,
    load_training_checkpoint,
    save_checkpoint,
    save_training_checkpoint,
)
from bayesian_torch_tpu_torch.utils.util import (  # noqa: F401
    entropy,
    mutual_information,
    predictive_entropy,
)
