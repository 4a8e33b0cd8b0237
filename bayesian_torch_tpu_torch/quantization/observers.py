"""Calibration observers and ``QConfig`` (counterpart of
``bayesian_torch_tpu/quantization/observers.py``; ``MinMaxObserver``, the
default of ``prepare``, so far).

An observer is an ``nn.Module`` whose running minimum and maximum are
buffers on the observed tensors' device; ``calculate_qparams`` reads them
on the host, with torch's conventions:

- qint8 per-tensor symmetric: scale = max(|min|, |max|) / 127.5, zp = 0;
- quint8 affine: scale = (max - min) / 255, zp = round(-min / scale).

``Observer.with_args(**kw)`` is the torch factory idiom, so a reference
``QConfig(weight=MinMaxObserver.with_args(dtype="qint8"), activation=...)``
ports verbatim.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
from torch import nn


class QConfig(NamedTuple):
    """(activation, weight) pair of observer factories, for ``prepare``."""

    activation: Any
    weight: Any


class MinMaxObserver(nn.Module):

    def __init__(self, dtype: str = "qint8"):
        super().__init__()
        if dtype not in ("qint8", "quint8"):
            raise ValueError(f"dtype must be 'qint8' or 'quint8', got "
                             f"{dtype!r}")
        self.dtype = dtype
        self.register_buffer("min_val", torch.tensor(float("inf")))
        self.register_buffer("max_val", torch.tensor(float("-inf")))

    @classmethod
    def with_args(cls, **kwargs):
        """A zero-argument factory building this observer with ``kwargs``."""
        return functools.partial(cls, **kwargs)

    def forward(self, x):
        """Record the running min and max of ``x``; returns ``x``."""
        d = x.detach()
        self.min_val = torch.minimum(self.min_val.to(d.device),
                                     d.amin().float())
        self.max_val = torch.maximum(self.max_val.to(d.device),
                                     d.amax().float())
        return x

    @property
    def observed(self) -> bool:
        return bool(torch.isfinite(self.min_val))

    def calculate_qparams(self):
        """(scale, zero_point) as Python floats, torch's semantics."""
        mn = float(self.min_val)
        mx = float(self.max_val)
        if not mn <= mx:  # never observed
            mn, mx = 0.0, 0.0
        mn = min(mn, 0.0)
        mx = max(mx, 0.0)
        if self.dtype == "qint8":
            amax = max(abs(mn), abs(mx))
            scale = amax / 127.5 if amax > 0 else 0.1
            return scale, 0.0
        scale = (mx - mn) / 255.0 if mx > mn else 0.1
        zp = round(-mn / scale)
        return scale, float(min(max(zp, 0), 255))
