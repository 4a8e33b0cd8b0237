"""Dropout wrapper with the (x, kl) tuple convention (counterpart of
``bayesian_torch_tpu/layers/dropout.py``), and the channel dropout
``Dropout2d`` of the JAX ``nn`` module. The mask comes from the layer's
CPU generator, so a seeded layer drops the same units anywhere."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    default_generator,
)
from bayesian_torch_tpu_torch.ops.sampling import current_window, draw_dim


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
        shape = self._mask_shape(x)
        window = current_window()
        if window is not None and (window.splits_rows
                                   or window.splits_draws):
            mask = self._window_mask(window, shape, keep, draw_dim(x))
        else:
            mask = torch.rand(shape, generator=self.generator) < keep
        return torch.where(mask.to(x.device), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def _mask_shape(self, x):
        return x.shape

    def _window_mask(self, window, shape, keep, dim=1):
        """This rank's block of the mask of the whole MC forward under a
        mesh: the whole batch's mask drawn, as one process draws it, and
        this rank's rows (and, under the draw axis, its draws' channel
        blocks on ``dim``: 1, or the last of a channels-last activation)
        taken."""
        whole = [window.rows] + list(shape[1:])
        draws = getattr(self, "_mc_draws", None)
        if draws and len(shape) > 1:
            whole[dim] = shape[dim] // draws * window.lanes
        mask = torch.rand(whole, generator=self.generator) < keep
        mask = mask.narrow(0, window.row0, shape[0])
        if draws and len(shape) > 1:
            per = shape[dim] // draws
            mask = mask.narrow(dim, window.lane0 * per, shape[dim])
        return mask

    def forward(self, input):
        if isinstance(input, tuple):
            x, _ = input
            return self._drop(x), 0
        return self._drop(input)


class Dropout2d(Dropout):
    """Channel dropout (the JAX ``nn.Dropout2d``): one draw per (sample,
    channel) of an NC* input, so whole channels drop; an (N, C) input
    drops element by element. ``torch.nn.Dropout2d`` would read a 2-d
    input as one unbatched sample and drop whole rows."""

    def _mask_shape(self, x):
        return tuple(x.shape[:2]) + (1,) * (x.dim() - 2)
