"""Tuple-threading containers; everything else is ``torch.nn``."""

from bayesian_torch_tpu_torch.nn.modules import Sequential  # noqa: F401
