"""Monte-Carlo inference over weight draws."""

from bayesian_torch_tpu_torch.parallel.mc import mc_forward  # noqa: F401
