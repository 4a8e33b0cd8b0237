"""BatchNorm wrapper layer with the (out, kl) tuple convention
(counterpart of ``bayesian_torch_tpu/layers/batchnorm.py``).

``torch.nn.BatchNorm2d`` with the reference's calling convention: a
``(x, kl)`` tuple in gives ``(out, 0)`` out, a bare tensor gives the bare
output. The eval path and the plain training path are torch's own. The
MC batch-statistics path (``MCBatchStats``) comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class BatchNorm2dLayer(nn.BatchNorm2d):

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: Optional[float] = 0.1, affine: bool = True,
                 track_running_stats: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, device=device)
        if affine and generator is not None:
            # reference init: weight ~ U(0, 1), bias = 0 (as the JAX layer
            # does when given rngs; without them the weight stays 1)
            with torch.no_grad():
                self.weight.copy_(torch.rand(num_features,
                                             generator=generator))

    def forward(self, input):
        if isinstance(input, tuple):
            x, _ = input
            return super().forward(x), 0
        return super().forward(input)

    def __repr__(self):
        return f"{type(self).__name__}()"
