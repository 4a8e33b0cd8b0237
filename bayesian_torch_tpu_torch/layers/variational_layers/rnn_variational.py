"""LSTM with the reparameterization estimator (counterpart of
``bayesian_torch_tpu/layers/variational_layers/rnn_variational.py``); see
``layers/rnn_base.py`` for the design."""

from bayesian_torch_tpu_torch.layers.rnn_base import _BaseLSTMLayer

__all__ = ["LSTMReparameterization"]


class LSTMReparameterization(_BaseLSTMLayer):
    estimator = "reparameterization"
