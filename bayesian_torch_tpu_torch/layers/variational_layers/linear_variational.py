"""Linear layer with the reparameterization MC estimator (counterpart of
``bayesian_torch_tpu/layers/variational_layers/linear_variational.py``).

Same constructor surface, parameter names and shapes (``mu_weight`` /
``rho_weight`` of shape (out_features, in_features)), init N(init, 0.1),
KL (weight mean + bias mean) and ``(out, kl)`` return convention with the
``dnn_to_bnn_flag`` bare-output mode. ``impl="pallas"`` keeps the JAX
value, so configs carry over: it routes the sampled GEMM through the
fused CUDA kernel (``ops/cuda/sampled_matmul.py``).

Under the draw axis (``_mc_draws``, set by ``mc_forward``'s vmap emission)
the input is (..., S*in_features) with draw s in block s, or shared, and
the output (..., S*out_features): ``impl="pallas"`` runs all S lanes of
the fused GEMM in one launch (``sampled_matmul_batched``) and the bias's
S draws in one batch-sampler launch; ``impl="xla"`` draws weight and bias
in one batch-sampler launch (or takes the presampled stack) and leaves
the product to ``torch.matmul`` (``ops.linear.linear_draws``).
"""

from __future__ import annotations

from typing import Optional

import torch

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    BaseVariationalLayer,
    default_generator,
)
from bayesian_torch_tpu_torch.ops import linear as linear_ops
from bayesian_torch_tpu_torch.ops.kl import gaussian_kl_from_rho
from bayesian_torch_tpu_torch.ops.sampling import (current_window,
                                                   draw_seed,
                                                   sample_gaussian_weight)

IMPLS = ("xla", "pallas")


class LinearReparameterization(BaseVariationalLayer):
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
        # "xla": sample W in torch, then F.linear; "pallas": the fused
        # sampled-GEMM kernel (names kept from the JAX layer)
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
        """Insert the calibration observers (5 qint8 + 2 quint8)."""
        self._make_observers(5, 2, qconfig)

    def forward(self, input, return_kl: bool = True, *, eps_w=None,
                eps_b=None):
        if self.dnn_to_bnn_flag:
            return_kl = False

        presampled_w = getattr(self, "_presampled_w", None)
        num_draws = getattr(self, "_mc_draws", None)
        if self.quant_prepare:
            out = self._observed_forward(input, self.mu_weight,
                                         self.rho_weight, linear_ops._linear)
        elif num_draws:
            out = self._forward_draws(input, num_draws, presampled_w)
        elif presampled_w is not None:
            # this draw's weights from the batch sampler (parallel.mc)
            out = linear_ops._linear(input, presampled_w,
                                     getattr(self, "_presampled_b", None),
                                     self.compute_dtype)
        elif self.impl == "pallas" and eps_w is None and eps_b is None:
            # fused sample-then-GEMM: the sampled W never exists in
            # device memory
            from bayesian_torch_tpu_torch.ops.cuda.sampled_matmul import (
                sampled_matmul,
            )
            lead = input.shape[:-1]
            out = sampled_matmul(
                draw_seed(self.generator),
                input.reshape(-1, self.in_features), self.mu_weight,
                self.rho_weight,
                out_dtype=self.compute_dtype or input.dtype)
            if self.mu_bias is not None:
                b, _ = sample_gaussian_weight(self.generator, self.mu_bias,
                                              self.rho_bias)
                out = out + b.to(out.dtype)
            out = out.reshape(lead + (self.out_features,))
        else:
            out = linear_ops.sampled_linear(
                input, self.generator, self.mu_weight, self.rho_weight,
                self.mu_bias, self.rho_bias, eps_w=eps_w, eps_b=eps_b,
                compute_dtype=self.compute_dtype)

        if return_kl:
            return out, self._kl_or_zero()
        return out

    def _forward_draws(self, input, num_draws, presampled_w):
        """All S draws at once: (..., S*in) or (..., in) -> (..., S*out)."""
        if presampled_w is not None:
            return linear_ops.linear_draws(
                input, presampled_w, getattr(self, "_presampled_b", None),
                self.compute_dtype)
        if self.impl == "xla":
            w, b = self._sample_draws(num_draws, self.mu_weight,
                                      self.rho_weight)
            return linear_ops.linear_draws(input, w, b, self.compute_dtype)
        from bayesian_torch_tpu_torch.ops.cuda.sampled_matmul import (
            sampled_matmul_batched,
        )
        from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
            sample_gaussian_batch,
        )
        window = current_window()
        if getattr(self, "_tp", None) is not None or (
                window is not None and window.splits_draws):
            raise NotImplementedError(
                "LinearReparameterization(impl='pallas') draws its lanes "
                "inside the fused sampled GEMM, which takes no window: under "
                "a mesh that splits the draws or the layer, use impl='xla'")
        out = sampled_matmul_batched(
            draw_seed(self.generator),
            linear_ops.split_draws(input, num_draws, self.in_features),
            self.mu_weight, self.rho_weight, num_draws,
            out_dtype=self.compute_dtype or input.dtype)
        if self.mu_bias is not None:
            # a seed of its own, as the JAX layer splits its key in two
            b = sample_gaussian_batch(draw_seed(self.generator),
                                      self.mu_bias, self.rho_bias,
                                      num_draws, self.mu_bias.dtype)
            out = out + b.to(out.dtype)[:, None]
        return linear_ops.join_draws(out, input.shape[:-1])

    def __repr__(self):  # used by MOPED string matching in the reference
        return "LinearReparameterization()"
