"""Monte-Carlo inference over weight draws."""

from bayesian_torch_tpu_torch.parallel.mc import (  # noqa: F401
    mc_forward,
    mc_vmap,
)
