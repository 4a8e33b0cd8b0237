"""Dropout wrapper with the (x, kl) tuple convention (counterpart of
``bayesian_torch_tpu/layers/dropout.py``). The mask comes from the
layer's CPU generator, so a seeded layer drops the same units anywhere."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    default_generator,
)


class Dropout(nn.Module):

    def __init__(self, p: float = 0.5, inplace: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if p < 0 or p > 1:
            raise ValueError(
                "dropout probability has to be between 0 and 1, "
                f"but got {p}")
        self.p = p
        self.inplace = inplace  # accepted for API parity
        self.generator = generator if generator is not None \
            else default_generator()

    def _drop(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return x * 0.0
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator) < keep
        return torch.where(mask.to(x.device), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, input):
        if isinstance(input, tuple):
            x, _ = input
            return self._drop(x), 0
        return self._drop(input)
