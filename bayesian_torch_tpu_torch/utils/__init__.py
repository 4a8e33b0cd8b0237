"""Checkpoints, weight transfer from the JAX package, the uncertainty
metrics, MOPED and ``freeze_batchnorm``."""

from bayesian_torch_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    load_jax_quant_state,
    load_jax_state,
    load_training_checkpoint,
    save_checkpoint,
    save_training_checkpoint,
)
from bayesian_torch_tpu_torch.utils.util import (  # noqa: F401
    MOPED,
    entropy,
    freeze_batchnorm,
    get_rho,
    mutual_information,
    predictive_entropy,
)
