"""Linear layer with the Flipout MC estimator, Wen et al. 2018
(counterpart of
``bayesian_torch_tpu/layers/flipout_layers/linear_flipout.py``).

Same constructor surface, parameter names and shapes as the
reparameterization layer. The mean product carries ``mu_weight`` and
``mu_bias``; the perturbation product carries ``sigma * eps`` with
per-call Rademacher input and output sign flips, and only ``sigma_b *
eps_b`` for the bias. ``impl`` is kept for configs that carry it; Flipout
has no fused kernel and both values run the same path.

A presampled weight (``_presampled_w``, set by ``mc_forward``) is the
perturbation ``delta = sigma * eps``, not a sampled weight. Under the draw
axis (``_mc_draws``) the input is (..., S*in_features) with draw s in block
s, or shared, and the output (..., S*out_features): the S perturbations
come from one batch-sampler launch on a zero mean (or the presampled
stack) and run through ``ops.linear.flipout_linear_draws``.
"""

from __future__ import annotations

from typing import Optional

import torch

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    BaseVariationalLayer,
    default_generator,
)
from bayesian_torch_tpu_torch.layers.variational_layers.linear_variational \
    import IMPLS
from bayesian_torch_tpu_torch.ops import linear as linear_ops
from bayesian_torch_tpu_torch.ops.kl import gaussian_kl_from_rho
from bayesian_torch_tpu_torch.utils import tracing

__all__ = ["LinearFlipout"]


class LinearFlipout(BaseVariationalLayer):
    estimator = "flipout"
    takes_draw_axis = True

    def __init__(self,
                 in_features: int,
                 out_features: int,
                 prior_mean: float = 0,
                 prior_variance: float = 1,
                 posterior_mu_init: float = 0,
                 posterior_rho_init: float = -3.0,
                 bias: bool = True,
                 *,
                 generator: Optional[torch.Generator] = None,
                 device=None,
                 compute_dtype=None,
                 impl: str = "xla"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.generator = generator if generator is not None \
            else default_generator()
        self.in_features = in_features
        self.out_features = out_features
        self.prior_mean = prior_mean
        self.prior_variance = prior_variance
        self.posterior_mu_init = posterior_mu_init
        self.posterior_rho_init = posterior_rho_init
        self.bias = bias
        self.compute_dtype = compute_dtype
        self.impl = impl

        self.mu_weight, self.rho_weight = self._init_posterior(
            (out_features, in_features), posterior_mu_init,
            posterior_rho_init, device)
        self._init_prior("prior_weight_mu", "prior_weight_sigma",
                         prior_mean, prior_variance, device)
        if bias:
            self.mu_bias, self.rho_bias = self._init_posterior(
                (out_features,), posterior_mu_init, posterior_rho_init,
                device)
            self._init_prior("prior_bias_mu", "prior_bias_sigma",
                             prior_mean, prior_variance, device)
        else:
            self._no_bias()

    def kl_loss(self):
        """Closed-form KL of the posterior against the prior."""
        kl = gaussian_kl_from_rho(self.mu_weight, self.rho_weight,
                                  self.prior_weight_mu,
                                  self.prior_weight_sigma)
        if self.mu_bias is not None:
            kl = kl + gaussian_kl_from_rho(self.mu_bias, self.rho_bias,
                                           self.prior_bias_mu,
                                           self.prior_bias_sigma)
        return kl

    def prepare(self, qconfig=None):
        """Insert the calibration observers (4 qint8 + 8 quint8)."""
        self._make_observers(4, 8, qconfig)

    @tracing.spanned("layer.bayes")
    def forward(self, x, return_kl: bool = True, *, eps_w=None, eps_b=None,
                sign_in=None, sign_out=None):
        if self.dnn_to_bnn_flag:
            return_kl = False

        presampled_w = getattr(self, "_presampled_w", None)
        presampled_b = getattr(self, "_presampled_b", None)
        num_draws = getattr(self, "_mc_draws", None)
        if self.quant_prepare:
            out = self._observed_forward_flipout(
                x, self.mu_weight, self.rho_weight, linear_ops._linear)
        elif num_draws:
            # all S draws: the presampled (S, ...) perturbations, or one
            # sampler launch on a zero mean
            if presampled_w is not None:
                delta, pert_b = presampled_w, presampled_b
            else:
                delta, pert_b = self._sample_draws(
                    num_draws, self.mu_weight, self.rho_weight,
                    zero_mean=True)
            out = linear_ops.flipout_linear_draws(
                x, self.mu_weight, self.mu_bias, delta, pert_b,
                self._sign_salts(num_draws), self.compute_dtype)
        elif presampled_w is not None:
            # this draw's perturbation from the batch sampler (parallel.mc)
            out = linear_ops.flipout_linear_presampled(
                x, self.mu_weight, self.mu_bias, presampled_w, presampled_b,
                self._sign_salts(), self.compute_dtype)
        else:
            out = linear_ops.flipout_linear(
                x, self.generator, self.mu_weight, self.rho_weight,
                self.mu_bias, self.rho_bias, eps_w=eps_w, eps_b=eps_b,
                sign_in=sign_in, sign_out=sign_out,
                compute_dtype=self.compute_dtype)

        if return_kl:
            return out, self._kl_or_zero()
        return out

    def __repr__(self):
        return "LinearFlipout()"
