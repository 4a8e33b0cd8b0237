"""Bayesian SCNN (Flipout), MNIST (counterpart of
``bayesian_torch_tpu/models/flipout/simple_cnn.py``)."""

from bayesian_torch_tpu_torch.models._scnn import _SCNN

__all__ = ["SCNN"]


class SCNN(_SCNN):
    estimator = "Flipout"
