"""BatchNorm layers with the MC batch-statistics path (counterpart of
``bayesian_torch_tpu/layers/batchnorm.py``).

``BatchNorm1d``, ``BatchNorm2d`` and ``BatchNorm3d`` are their
``torch.nn`` classes with the JAX layer's ``stats_frozen`` switch: while
it is set, a training-mode forward still normalizes by the batch's own
statistics but writes no running statistic (and does not count the
batch). ``parallel.mc.mc_forward`` sets it for its
draw loop; with a ``MCBatchStats`` record attached, each draw's batch
(mean, unbiased variance) is recorded, and the caller applies ONE EMA
update from their average after the loop. Otherwise the eval path and the
plain training path are torch's own. A ``QTensor`` input (a quantized
conv's uint8 output) is dequantized first.

Under ``mc_forward``'s vmap emission (``_mc_draws`` = S) the input is
(B, S*C, ...) with draw s in channel block s. Each block is normalised as
the plain forward normalises one draw: by its own batch statistics in
training mode (per-channel statistics of the S*C channels, recorded for
all S draws at once) and by the running statistics tiled S times in eval.

Under ``mc_forward(mesh=)`` with the batch split over ranks (a
``DrawWindow`` that splits the rows), batch statistics are those of the
whole batch, as GSPMD takes them: each rank's per-channel sums are summed
over the mesh's 'data' axis (two passes: the mean, then the squared
deviations), with a backward that sums the ranks' parts
(``parallel/_comm.all_reduce_partial``).

A checkpoint's recompute (``ops/remat.py``) runs under ``recomputing``:
each layer then takes the path its forward took, so the recompute saves
the same tensors, but neither counts the batch, nor records it, nor moves
a running statistic (torch's update runs at momentum 0).

``data_format`` (JAX ``batchnorm.py``: "NCHW", or channels-last "NHWC"):
a channels-last layer takes and returns (B, *sp, C) and normalises the
(B, C, *sp) view of it, channels-last in memory, so torch's BatchNorm runs
on it without a copy; under the draw axis the input is (B, *sp, S*C) and
each draw's block of the last axis is normalised by its own statistics
(JAX's structured branch), recorded for one EMA update as under NCHW.

``BatchNorm1dLayer``, ``BatchNorm2dLayer`` and ``BatchNorm3dLayer`` add
the reference's calling convention: a ``(x, kl)`` tuple in gives
``(out, 0)`` out, a bare tensor gives the bare output.
``QuantizedBatchNorm2d`` (``bnn_to_qbnn(..., quantize_batchnorm=True)``)
also requantizes its output when its input was a ``QTensor``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bayesian_torch_tpu_torch.ops.conv import (channels_last, from_nc,
                                               to_nc)
from bayesian_torch_tpu_torch.ops.qtensor import (QTensor,
                                                  dequantize_if_qtensor)
from bayesian_torch_tpu_torch.ops.sampling import current_window
from bayesian_torch_tpu_torch.utils import tracing


class MCBatchStats:
    """Per-draw batch statistics of one BatchNorm layer under an MC draw
    loop: draw s records (mean, unbiased variance) per channel, in f32
    and detached (the JAX ``MCBatchStats`` variable, (num_mc, 2, C))."""

    def __init__(self):
        self.draws = []

    def record(self, x, num_draws=1):
        """Record the statistics of ``num_draws`` draws from x (B,
        num_draws*C, ...), draw s in channel block s."""
        dims = (0,) + tuple(range(2, x.dim()))
        with torch.no_grad():
            var, mean = torch.var_mean(x.detach().float(), dim=dims,
                                       unbiased=True)
        self.record_stats(mean, var, num_draws)

    def record_stats(self, mean, unbiased_var, num_draws=1):
        """Record given per-channel statistics of ``num_draws`` draws."""
        self.draws.append(torch.stack(
            [mean.detach().float().reshape(num_draws, -1),
             unbiased_var.detach().float().reshape(num_draws, -1)], dim=1))

    def stacked(self):
        """(num_draws, 2, C): each draw's (mean, unbiased variance)."""
        return torch.cat(self.draws)


class _MCBatchNorm:
    """``stats_frozen``, an optional per-draw ``MCBatchStats`` record
    (``_mc_stats``) and the draw-axis forward, over a ``torch.nn``
    BatchNorm class."""

    takes_draw_axis = True

    def __init__(self, *args, data_format: str = "NCHW", **kwargs):
        super().__init__(*args, **kwargs)
        self.data_format = data_format  # NCHW (torch) or NHWC/channels-last
        self.stats_frozen = False
        self._mc_stats: Optional[MCBatchStats] = None
        self._recomputing = False

    @tracing.spanned("layer.bn")
    def forward(self, input):
        input = dequantize_if_qtensor(input)
        if channels_last(self.data_format):
            return from_nc(self._forward_nc(to_nc(input, self.data_format)),
                           self.data_format)
        return self._forward_nc(input)

    def _forward_nc(self, input):
        """The forward on NC* activations (a channels-last input's view)."""
        num_draws = getattr(self, "_mc_draws", None)
        if num_draws and input.shape[1] == num_draws * self.num_features:
            return self._forward_draws(input, num_draws)
        window = current_window()
        if window is not None and window.splits_rows and (
                self.training or self.running_mean is None):
            return self._forward_synced(input, window)
        updating = self.training and self.track_running_stats
        if updating and self._recomputing and not self.stats_frozen:
            # torch's update, as the forward ran it, at momentum 0: the
            # running statistics keep their values
            self._check_input_dim(input)
            return F.batch_norm(input, self.running_mean, self.running_var,
                                self.weight, self.bias, True, 0.0, self.eps)
        if not (self.stats_frozen and updating):
            return super().forward(input)
        self._check_input_dim(input)
        if self._mc_stats is not None and not self._recomputing:
            self._mc_stats.record(input)
        # batch statistics, no running statistic read or written
        return F.batch_norm(input, None, None, self.weight, self.bias,
                            True, 0.0, self.eps)

    def _forward_draws(self, x, num_draws):
        """x (B, S*C, ...): each draw's block by its own batch statistics
        (training, recorded if a record is attached) or by the running
        statistics (eval); no running statistic is written."""
        self._check_input_dim(x)

        def tile(t):
            return None if t is None else t.repeat(num_draws)

        if self.training or self.running_mean is None:
            window = current_window()
            if window is not None and window.splits_rows:
                out, mean, var = self._synced(x, window, tile(self.weight),
                                              tile(self.bias))
                if self._mc_stats is not None and not self._recomputing:
                    self._mc_stats.record_stats(mean, var, num_draws)
                return out
            if self._mc_stats is not None and not self._recomputing:
                self._mc_stats.record(x, num_draws)
            return F.batch_norm(x, None, None, tile(self.weight),
                                tile(self.bias), True, 0.0, self.eps)
        return F.batch_norm(x, tile(self.running_mean),
                            tile(self.running_var), tile(self.weight),
                            tile(self.bias), False, 0.0, self.eps)


    def _synced(self, x, window, weight, bias):
        """Normalise x by the whole batch's statistics (the mesh's 'data'
        ranks hold the other rows): (output, mean, unbiased variance)."""
        from bayesian_torch_tpu_torch.parallel._comm import (
            all_reduce_partial,
        )
        self._check_input_dim(x)
        group = window.data_group
        dims = (0,) + tuple(range(2, x.dim()))
        view = (1, -1) + (1,) * (x.dim() - 2)
        n = x.numel() // x.shape[1] * (window.rows // window.local_rows)
        xf = x.float()
        mean = all_reduce_partial(xf.sum(dims), group) / n
        centred = xf - mean.reshape(view)
        var = all_reduce_partial((centred * centred).sum(dims), group) / n
        out = centred * torch.rsqrt(var + self.eps).reshape(view)
        if weight is not None:
            out = out * weight.float().reshape(view) \
                + bias.float().reshape(view)
        return out.to(x.dtype), mean, var * (n / max(n - 1, 1))

    def _forward_synced(self, x, window):
        """One forward over a batch split over ranks: the whole batch's
        statistics; a running-statistics update (torch's rule) unless the
        statistics are frozen or recorded, or this is a recompute."""
        out, mean, var = self._synced(x, window, self.weight, self.bias)
        if not (self.training and self.track_running_stats):
            return out
        if self.stats_frozen:
            if self._mc_stats is not None and not self._recomputing:
                self._mc_stats.record_stats(mean, var)
        elif not self._recomputing:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                factor = (1.0 / float(self.num_batches_tracked)
                          if self.momentum is None else self.momentum)
                self.running_mean.mul_(1 - factor).add_(
                    factor * mean.to(self.running_mean.dtype))
                self.running_var.mul_(1 - factor).add_(
                    factor * var.to(self.running_var.dtype))
        return out


@contextlib.contextmanager
def recomputing(module):
    """Set the recompute state on every MC-aware BatchNorm of the module
    for the duration (module docstring)."""
    mods = [m for m in module.modules() if isinstance(m, _MCBatchNorm)]
    for mod in mods:
        mod._recomputing = True
    try:
        yield
    finally:
        for mod in mods:
            mod._recomputing = False


class BatchNorm1d(_MCBatchNorm, nn.BatchNorm1d):
    """``torch.nn.BatchNorm1d`` with the MC batch-statistics path."""


class BatchNorm2d(_MCBatchNorm, nn.BatchNorm2d):
    """``torch.nn.BatchNorm2d`` with the MC batch-statistics path."""


class BatchNorm3d(_MCBatchNorm, nn.BatchNorm3d):
    """``torch.nn.BatchNorm3d`` with the MC batch-statistics path."""


class _BatchNormLayer:
    """The reference's constructor and ``(x, kl)`` calling convention."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: Optional[float] = 0.1, affine: bool = True,
                 track_running_stats: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 data_format: str = "NCHW"):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, device=device,
                         data_format=data_format)
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


class BatchNorm1dLayer(_BatchNormLayer, BatchNorm1d):
    pass


class BatchNorm2dLayer(_BatchNormLayer, BatchNorm2d):
    pass


class BatchNorm3dLayer(_BatchNormLayer, BatchNorm3d):
    pass


class QuantizedBatchNorm2d(BatchNorm2dLayer):
    """BatchNorm that keeps the uint8 activation flow quantized (the
    reference's ``qbnn_batchnorm2d_layer`` target): a ``QTensor`` input is
    normalized in f32 and its output requantized to (``scale``,
    ``zero_point``), by default (0.1, 128), which holds +-12.8 (BN outputs
    are O(1)); a float input gives the float output."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: Optional[float] = 0.1, affine: bool = True,
                 track_running_stats: bool = True, *, scale: float = 0.1,
                 zero_point: int = 128,
                 generator: Optional[torch.Generator] = None, device=None,
                 data_format: str = "NCHW"):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats, generator=generator,
                         device=device, data_format=data_format)
        self.scale = scale
        self.zero_point = zero_point

    def forward(self, input):
        x, was_tuple = (input[0], True) if isinstance(input, tuple) \
            else (input, False)
        if isinstance(x, QTensor):
            out = BatchNorm2d.forward(self, x.dequantize())
            q = torch.round(out.float() * (1.0 / self.scale)) \
                + self.zero_point
            out = QTensor(torch.clamp(q, 0, 255).to(torch.uint8),
                          self.scale, self.zero_point)
        else:
            out = BatchNorm2d.forward(self, x)
        return (out, 0) if was_tuple else out
