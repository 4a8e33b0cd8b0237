"""``Sequential`` that threads (x, kl) tuples, and the MC-aware
``BatchNorm2d`` (counterparts of ``Sequential`` and ``BatchNorm2d`` of
``bayesian_torch_tpu/nn/modules.py``; the other modules there are twins of
``torch.nn``, which the port uses directly)."""

from torch import nn

from bayesian_torch_tpu_torch.layers.batchnorm import BatchNorm2d  # noqa: F401,E501


class Sequential(nn.Sequential):
    """If a child returns an ``(x, kl)`` pair, its kl is accumulated and
    the pair is re-formed at the end, so a Bayesian downsample path
    ``Sequential(conv, BatchNorm2dLayer)`` returns the conv's KL."""

    def forward(self, x):
        kl_total = None
        for mod in self:
            out = mod(x)
            if isinstance(out, tuple) and len(out) == 2:
                x, kl = out
                kl_total = kl if kl_total is None else kl_total + kl
            else:
                x = out
        if kl_total is not None:
            return x, kl_total
        return x
