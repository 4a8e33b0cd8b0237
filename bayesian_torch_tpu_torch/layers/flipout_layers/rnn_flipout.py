"""LSTM with the Flipout estimator (counterpart of
``bayesian_torch_tpu/layers/flipout_layers/rnn_flipout.py``); see
``layers/rnn_base.py`` for the design."""

from bayesian_torch_tpu_torch.layers.rnn_base import _BaseLSTMLayer

__all__ = ["LSTMFlipout"]


class LSTMFlipout(_BaseLSTMLayer):
    estimator = "flipout"
