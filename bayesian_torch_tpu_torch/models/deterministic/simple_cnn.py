"""Deterministic SCNN, MNIST: the MOPED source and ``dnn_to_bnn`` input
(counterpart of ``bayesian_torch_tpu/models/deterministic/simple_cnn.py``).
"""

from bayesian_torch_tpu_torch.models._scnn import _SCNN

__all__ = ["SCNN"]


class SCNN(_SCNN):
    estimator = None
