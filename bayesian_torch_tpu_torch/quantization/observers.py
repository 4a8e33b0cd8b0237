"""Calibration observers and ``QConfig`` (counterpart of
``bayesian_torch_tpu/quantization/observers.py``): ``MinMaxObserver``, the
default of ``prepare``, ``PerChannelMinMaxObserver`` and
``HistogramObserver``.

An observer is an ``nn.Module`` whose running state (minimum, maximum,
histogram) is held in buffers on the observed tensors' device;
``calculate_qparams`` reads it on the host, with torch's conventions:

- qint8 per-tensor symmetric: scale = max(|min|, |max|) / 127.5, zp = 0;
- quint8 affine: scale = (max - min) / 255, zp = round(-min / scale).

``Observer.with_args(**kw)`` is the torch factory idiom, so a reference
``QConfig(weight=MinMaxObserver.with_args(dtype="qint8"), activation=...)``
ports verbatim.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn


class QConfig(NamedTuple):
    """(activation, weight) pair of observer factories, for ``prepare``."""

    activation: Any
    weight: Any


class _Observer(nn.Module):
    """dtype check, the running min / max buffers and ``with_args``."""

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


class MinMaxObserver(_Observer):

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


class PerChannelMinMaxObserver(_Observer):
    """Per-channel min / max along ``ch_axis``; ``calculate_qparams``
    gives per-channel numpy arrays with the formulas above. The
    ``quant_dict`` of the Bayesian layers is per tensor, so converting a
    layer calibrated with it raises (``bnn_to_qbnn``); it serves
    standalone, weight-granular use."""

    def __init__(self, dtype: str = "qint8", ch_axis: int = 0):
        super().__init__(dtype)
        self.ch_axis = ch_axis

    def forward(self, x):
        d = x.detach().float()
        axis = self.ch_axis % d.dim()
        flat = d.movedim(axis, 0).reshape(d.shape[axis], -1)
        # the first observation grows the scalar +-inf seeds to (C,)
        self.min_val = torch.minimum(self.min_val.to(d.device),
                                     flat.amin(dim=1))
        self.max_val = torch.maximum(self.max_val.to(d.device),
                                     flat.amax(dim=1))
        return x

    @property
    def observed(self) -> bool:
        return bool(torch.isfinite(self.min_val).all())

    def calculate_qparams(self):
        """Per-channel (scale, zero_point) float64 arrays."""
        mn = np.minimum(self.min_val.cpu().double().numpy(), 0.0)
        mx = np.maximum(self.max_val.cpu().double().numpy(), 0.0)
        if mn.ndim == 0:  # never observed
            mn, mx = np.zeros((1,)), np.zeros((1,))
        if self.dtype == "qint8":
            amax = np.maximum(np.abs(mn), np.abs(mx))
            scale = np.where(amax > 0, amax / 127.5, 0.1)
            return scale, np.zeros_like(scale)
        scale = np.where(mx > mn, (mx - mn) / 255.0, 0.1)
        return scale, np.clip(np.round(-mn / scale), 0, 255)


def _linspace(lo, hi, num):
    """num f32 points from lo to hi: lo*(1 - t) + hi*t with t = i/(num-1),
    the last point hi itself (the JAX ``linspace`` formula)."""
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=lo.device) / div
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of (xp, fp) at x, clamped to fp's
    ends outside xp (``jnp.interp``'s formula)."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class HistogramObserver(_Observer):
    """A running histogram on ``bins`` bins with torch
    ``HistogramObserver``'s L2-minimising search for the clip range.

    The bins' edges track the running [min, max]; when the range grows,
    the old counts are remapped onto the new edges through the
    piecewise-linear CDF (uniform mass within a bin; total mass kept). The
    search's objective is the expected L2 error of the quantized values,
    where clipped mass pays its full squared distance to the clip
    boundary: rare far outliers are not clipped, and on such data the
    result equals ``MinMaxObserver``'s. The recording runs on the
    observed tensors' device in f32, in the JAX observer's formulas; the
    search runs on the host in float64."""

    def __init__(self, dtype: str = "quint8", bins: int = 2048):
        super().__init__(dtype)
        self.bins = bins
        self.register_buffer("histogram", torch.zeros(bins))

    @staticmethod
    def _span(mn, mx):
        """The histogram's support for a running (min, max): widened by
        0.5 each way when degenerate, so constant data fills a real bin."""
        ok = mx > mn
        return torch.where(ok, mn, mn - 0.5), torch.where(ok, mx, mx + 0.5)

    def forward(self, x):
        xf = x.detach().float().reshape(-1)
        dev = xf.device
        old_mn, old_mx = self.min_val.to(dev), self.max_val.to(dev)
        hist = self.histogram.to(dev)
        new_mn = torch.minimum(old_mn, xf.amin())
        new_mx = torch.maximum(old_mx, xf.amax())
        lo, hi = self._span(new_mn, new_mx)
        new_edges = _linspace(lo, hi, self.bins + 1)
        if bool(torch.isfinite(old_mn)):
            old_lo, old_hi = self._span(old_mn, old_mx)
            cdf = torch.cat([hist.new_zeros(1), torch.cumsum(hist, 0)])
            hist = torch.diff(_interp(new_edges,
                                      _linspace(old_lo, old_hi,
                                                self.bins + 1), cdf))
        else:
            hist = torch.zeros_like(hist)
        # jnp.histogram: bin i holds edges[i] <= v < edges[i+1], the last
        # bin its right edge too
        idx = torch.searchsorted(new_edges, xf, right=True)
        idx = torch.where(xf == new_edges[-1], self.bins, idx)
        fresh = torch.bincount(idx, minlength=self.bins + 2)
        self.histogram = hist + fresh[1:self.bins + 1].float()
        self.min_val, self.max_val = new_mn, new_mx
        return x

    @property
    def observed(self) -> bool:
        return bool(torch.isfinite(self.min_val))

    @staticmethod
    def _get_norm(delta_begin, delta_end, density):
        """L2 norm of the quantization error over an interval of uniform
        density, measured from the target level."""
        return density * (delta_end ** 3 - delta_begin ** 3) / 3.0

    def _quantization_error(self, hist, mn, mx, start_bin, end_bin,
                            dst_nbins=256):
        """Expected L2 error of quantizing the histogram onto ``dst_nbins``
        levels spanning bins [start_bin, end_bin]; bins outside clamp to
        the edge level and pay their full squared distance to it."""
        bin_width = (mx - mn) / self.bins
        dst_bin_width = bin_width * (end_bin - start_bin + 1) / dst_nbins
        if dst_bin_width == 0.0:
            return 0.0
        src_bin = np.arange(self.bins, dtype=np.float64)
        src_bin_begin = (src_bin - start_bin) * bin_width
        src_bin_end = src_bin_begin + bin_width
        dst_bin_of_begin = np.clip(
            np.floor(src_bin_begin / dst_bin_width), 0, dst_nbins - 1)
        dst_bin_of_begin_center = (dst_bin_of_begin + 0.5) * dst_bin_width
        dst_bin_of_end = np.clip(
            np.floor(src_bin_end / dst_bin_width), 0, dst_nbins - 1)
        density = hist / bin_width
        norm = self._get_norm(src_bin_begin - dst_bin_of_begin_center,
                              np.full(self.bins, dst_bin_width / 2), density)
        norm += (dst_bin_of_end - dst_bin_of_begin - 1) * self._get_norm(
            -dst_bin_width / 2, dst_bin_width / 2, density)
        dst_bin_of_end_center = (dst_bin_of_end + 0.5) * dst_bin_width
        norm += self._get_norm(-dst_bin_width / 2,
                               src_bin_end - dst_bin_of_end_center, density)
        return float(norm.sum())

    def _non_linear_param_search(self, hist, mn, mx):
        """torch's search: walk the quantile bounds inward in 1e-5 steps,
        moving whichever side trails, while the L2 error keeps falling.
        Returns (new_min, new_max)."""
        bin_width = (mx - mn) / self.bins
        total = float(hist.sum())
        csum = np.cumsum(hist)
        stepsize = 1e-5
        alpha, beta = 0.0, 1.0
        start_bin, end_bin = 0, self.bins - 1
        norm_min = np.inf
        while alpha < beta:
            next_alpha = alpha + stepsize
            next_beta = beta - stepsize
            left = int(np.searchsorted(csum, next_alpha * total, "left"))
            left = min(max(left, start_bin), end_bin)
            right = int(np.searchsorted(csum, next_beta * total,
                                        "right")) - 1
            right = max(min(right, end_bin), start_bin)
            next_start, next_end = start_bin, end_bin
            if (left - start_bin) > (end_bin - right):
                next_start = left
                alpha = next_alpha
            else:
                next_end = right
                beta = next_beta
            if next_start == start_bin and next_end == end_bin:
                continue
            norm = self._quantization_error(hist, mn, mx, next_start,
                                            next_end)
            if norm > norm_min:
                break
            norm_min = norm
            start_bin, end_bin = next_start, next_end
        return mn + bin_width * start_bin, mn + bin_width * (end_bin + 1)

    def calculate_qparams(self):
        mn = float(self.min_val)
        mx = float(self.max_val)
        hist = self.histogram.cpu().double().numpy()
        if not (mn < mx) or hist.sum() <= 0:
            return MinMaxObserver.calculate_qparams(self)
        new_mn, new_mx = self._non_linear_param_search(hist, mn, mx)
        if self.dtype == "qint8":
            amax = max(abs(new_mn), abs(new_mx))
            return (amax / 127.5 if amax > 0 else 0.1), 0.0
        new_mn, new_mx = min(new_mn, 0.0), max(new_mx, 0.0)
        scale = (new_mx - new_mn) / 255.0
        if scale <= 0:
            return 0.1, 0.0
        zp = round(-new_mn / scale)
        return scale, float(min(max(zp, 0), 255))
