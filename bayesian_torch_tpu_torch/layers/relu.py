"""ReLU wrapper with the (x, kl) tuple convention (counterpart of
``bayesian_torch_tpu/layers/relu.py``)."""

import torch.nn.functional as F
from torch import nn


class ReLU(nn.Module):

    def __init__(self, inplace: bool = False):
        super().__init__()
        self.inplace = inplace

    def forward(self, input):
        if isinstance(input, tuple):
            x, _ = input
            return F.relu(x, inplace=self.inplace), 0
        return F.relu(input, inplace=self.inplace)
