"""The MNIST SCNN in three forms: deterministic, reparameterization and
Flipout (counterpart of ``bayesian_torch_tpu/models/_scnn.py``).

Conv(1->32, k3) - ReLU - Conv(32->64, k3) - ReLU - MaxPool(2) -
Dropout2d(0.25) - Flatten - Linear(9216->128) - ReLU - Dropout2d(0.5) -
Linear(128->10) - log_softmax, on 28x28 inputs. The Bayesian forms thread
the KL and return ``(log_probs, kl)``; the deterministic one
(``torch.nn`` layers, torch's default init drawn from the model's
generator) returns the log-probabilities.

Under the draw axis (``mc_forward``'s vmap emission, ``_mc_draws`` = S)
the head's output is (B, S*10) with draw s in block s: the log_softmax is
taken within each block, as each draw's own forward takes it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    default_generator,
)
from bayesian_torch_tpu_torch.layers.dropout import Dropout2d
from bayesian_torch_tpu_torch.nn import functional as F

prior_mu = 0.0
prior_sigma = 1.0
posterior_mu_init = 0.0
posterior_rho_init = -3.0


def _torch_default(module, generator, fan_in):
    """torch's default init of a conv or linear layer, U(+-1/sqrt(fan_in))
    for weight and bias, drawn from ``generator`` on the CPU."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(bound * (2 * torch.rand(p.shape, generator=generator)
                             - 1))
    return module


def _factories(estimator, generator, device):
    if estimator is None:
        device = device if device is not None else "cpu"

        def conv(cin, cout, k, **kw):
            return _torch_default(
                nn.utils.skip_init(nn.Conv2d, cin, cout, k, device=device,
                                   **kw), generator, cin * k * k)

        def linear(cin, cout):
            return _torch_default(
                nn.utils.skip_init(nn.Linear, cin, cout, device=device),
                generator, cin)
        return conv, linear
    from bayesian_torch_tpu_torch import layers

    bkw = dict(prior_mean=prior_mu, prior_variance=prior_sigma,
               posterior_mu_init=posterior_mu_init,
               posterior_rho_init=posterior_rho_init, generator=generator,
               device=device)
    conv_cls = getattr(layers, f"Conv2d{estimator}")
    linear_cls = getattr(layers, f"Linear{estimator}")

    def conv(cin, cout, k, **kw):
        return conv_cls(cin, cout, k, **bkw, **kw)

    def linear(cin, cout):
        return linear_cls(cin, cout, **bkw)
    return conv, linear


def log_softmax_per_draw(x, num_draws=None):
    """log_softmax over the classes of (B, C), or of each draw's block of
    (B, S*C) when ``num_draws`` = S."""
    if num_draws:
        return torch.log_softmax(x.unflatten(1, (num_draws, -1)),
                                 dim=-1).flatten(1)
    return torch.log_softmax(x, dim=1)


class _SCNN(nn.Module):
    estimator: Optional[str] = None  # None: deterministic

    def __init__(self, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if generator is None:
            generator = default_generator()
        conv, linear = _factories(self.estimator, generator, device)
        self.conv1 = conv(1, 32, 3, stride=1)
        self.conv2 = conv(32, 64, 3, stride=1)
        self.dropout1 = Dropout2d(0.25, generator=generator)
        self.dropout2 = Dropout2d(0.5, generator=generator)
        self.fc1 = linear(9216, 128)
        self.fc2 = linear(128, 10)

    @staticmethod
    def _maybe(out, kl_sum):
        if isinstance(out, tuple):
            x, kl = out
            return x, kl_sum + kl
        return out, kl_sum

    def forward(self, x):
        kl_sum = 0.0
        x, kl_sum = self._maybe(self.conv1(x), kl_sum)
        x = F.relu(x)
        x, kl_sum = self._maybe(self.conv2(x), kl_sum)
        x = F.relu(x)
        x = F.max_pool_nd(x, 2)
        x = self.dropout1(x)
        x = x.reshape(x.shape[0], -1)
        x, kl_sum = self._maybe(self.fc1(x), kl_sum)
        x = F.relu(x)
        x = self.dropout2(x)
        x, kl_sum = self._maybe(self.fc2(x), kl_sum)
        output = log_softmax_per_draw(x, getattr(self, "_mc_draws", None))
        if self.estimator is None:
            return output
        return output, kl_sum
