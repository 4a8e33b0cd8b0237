"""Bayesian SCNN (reparameterization), MNIST (counterpart of
``bayesian_torch_tpu/models/bayesian/simple_cnn_variational.py``)."""

from bayesian_torch_tpu_torch.models._scnn import _SCNN

__all__ = ["SCNN"]


class SCNN(_SCNN):
    estimator = "Reparameterization"
