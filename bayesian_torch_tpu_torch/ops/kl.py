"""Closed-form Gaussian KL divergence (counterpart of
``bayesian_torch_tpu/ops/kl.py``).

``kl = log(sigma_p) - log(sigma_q) + (sigma_q^2 + (mu_q-mu_p)^2) /
(2 sigma_p^2) - 0.5``, reduced by the **mean** over elements. A layer adds
its weight mean and its bias mean; ``get_kl_loss`` sums the layers.
"""

from __future__ import annotations

import torch

from bayesian_torch_tpu_torch.ops.sampling import (log_sigma_from_rho,
                                                   sigma_from_rho)


def gaussian_kl(mu_q, sigma_q, mu_p, sigma_p, *, log_sigma_q=None):
    """Mean-reduced KL(N(mu_q, sigma_q^2) || N(mu_p, sigma_p^2)).

    ``mu_p``/``sigma_p`` may be scalars or tensors broadcastable against
    ``mu_q`` (MOPED empirical priors).
    """
    mu_p = torch.as_tensor(mu_p, dtype=mu_q.dtype, device=mu_q.device)
    sigma_p = torch.as_tensor(sigma_p, dtype=mu_q.dtype, device=mu_q.device)
    if log_sigma_q is None:
        log_sigma_q = torch.log(sigma_q)
    kl = (torch.log(sigma_p) - log_sigma_q
          + (sigma_q ** 2 + (mu_q - mu_p) ** 2) / (2.0 * sigma_p ** 2)
          - 0.5)
    return kl.mean()


def gaussian_kl_from_rho(mu_q, rho_q, mu_p, sigma_p):
    """gaussian_kl with sigma_q = softplus(rho_q), underflow-stable."""
    return gaussian_kl(mu_q, sigma_from_rho(rho_q), mu_p, sigma_p,
                       log_sigma_q=log_sigma_from_rho(rho_q))
