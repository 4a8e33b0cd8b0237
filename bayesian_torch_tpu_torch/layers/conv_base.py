"""Shared implementation of the Bayesian conv layers (counterpart of
``bayesian_torch_tpu/layers/conv_base.py``, both estimators, plain and
transposed).

The public subclasses pin ``nd``, ``transposed`` and ``estimator``
("reparameterization" or "flipout") and keep the reference's class names,
constructor signatures, parameter names (``mu_kernel`` / ``rho_kernel``)
and shapes:

- Conv:          (out_channels, in_channels // groups, *kernel_size);
- ConvTranspose: (in_channels, out_channels // groups, *kernel_size),
  with ``output_padding`` (after ``bias``, as in the JAX layer).

Under the draw axis (``_mc_draws``, set by ``mc_forward``'s vmap emission)
the layer takes its S kernels from one batch-sampler launch, or the whole
presampled (S, ...) stack, and runs them as one conv
(``ops.conv.conv_draws``), as the JAX layer's structured branch does. A
Flipout layer draws its S perturbations ``sigma * eps`` the same way (the
sampler on a zero mean) and runs ``ops.conv.flipout_conv_draws``; its
presampled weight is that perturbation, and the mean conv uses ``mu``.
The JAX package refuses transposed convs only in its structured mode; the
port's draw axis (and so its ``structured=True``) takes them.

``data_format`` ("NCHW", the default, or channels-last "NHWC", stored as
the JAX layer stores it) is the activations' layout on all three routes:
the single draw, the presampled weight and the draw axis, whose channels-
last layout (B, *sp, S*C) is JAX's structured one. Kernels keep their
layouts, so parameters, ``state_dict`` keys and the samplers' launches
are the same in either layout. A Flipout layer's signs are hashed over
the tensors as they are, (B, H, W, C) under NHWC, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    BaseVariationalLayer,
    default_generator,
    get_kernel_size,
)
from bayesian_torch_tpu_torch.ops import conv as conv_ops
from bayesian_torch_tpu_torch.ops.kl import gaussian_kl_from_rho
from bayesian_torch_tpu_torch.utils import tracing


class _BaseConvLayer(BaseVariationalLayer):
    """Common constructor, KL and forward of the Bayesian convs."""

    nd: int = 2
    transposed: bool = False
    estimator: str = "reparameterization"  # or "flipout"
    takes_draw_axis = True

    def __init__(self,
                 in_channels: int,
                 out_channels: int,
                 kernel_size,
                 stride=1,
                 padding=0,
                 dilation=1,
                 groups: int = 1,
                 prior_mean: float = 0,
                 prior_variance: float = 1,
                 posterior_mu_init: float = 0,
                 posterior_rho_init: float = -3.0,
                 bias: bool = True,
                 output_padding=0,
                 *,
                 generator: Optional[torch.Generator] = None,
                 device=None,
                 compute_dtype=None,
                 data_format: str = "NCHW"):
        super().__init__()
        if in_channels % groups != 0:
            raise ValueError("invalid in_channels size")
        if out_channels % groups != 0:
            raise ValueError("invalid out_channels size")
        self.generator = generator if generator is not None \
            else default_generator()

        kernel_size = get_kernel_size(kernel_size, self.nd)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.output_padding = output_padding
        self.prior_mean = prior_mean
        self.prior_variance = prior_variance
        self.posterior_mu_init = posterior_mu_init
        self.posterior_rho_init = posterior_rho_init
        self.bias = bias
        self.compute_dtype = compute_dtype
        self.data_format = data_format  # NCHW (torch) or NHWC/channels-last

        if self.transposed:
            kshape = (in_channels, out_channels // groups) + kernel_size
        else:
            kshape = (out_channels, in_channels // groups) + kernel_size
        self.mu_kernel, self.rho_kernel = self._init_posterior(
            kshape, posterior_mu_init, posterior_rho_init, device)
        self._init_prior("prior_weight_mu", "prior_weight_sigma",
                         prior_mean, prior_variance, device)
        if bias:
            self.mu_bias, self.rho_bias = self._init_posterior(
                (out_channels,), posterior_mu_init, posterior_rho_init,
                device)
            self._init_prior("prior_bias_mu", "prior_bias_sigma",
                             prior_mean, prior_variance, device)
        else:
            self._no_bias()

    def kl_loss(self):
        """Weight-mean KL plus bias-mean KL."""
        kl = gaussian_kl_from_rho(self.mu_kernel, self.rho_kernel,
                                  self.prior_weight_mu,
                                  self.prior_weight_sigma)
        if self.mu_bias is not None:
            kl = kl + gaussian_kl_from_rho(self.mu_bias, self.rho_bias,
                                           self.prior_bias_mu,
                                           self.prior_bias_sigma)
        return kl

    def _conv_args(self):
        return dict(stride=self.stride, padding=self.padding,
                    output_padding=self.output_padding,
                    dilation=self.dilation, groups=self.groups,
                    transposed=self.transposed,
                    compute_dtype=self.compute_dtype,
                    data_format=self.data_format)

    def prepare(self, qconfig=None):
        """Insert the calibration observers: 5 qint8 + 2 quint8, Flipout
        4 qint8 + 8 quint8."""
        if self.estimator == "flipout":
            self._make_observers(4, 8, qconfig)
        else:
            self._make_observers(5, 2, qconfig)

    def _forward_flipout(self, input, eps_k, eps_b, sign_in, sign_out):
        presampled_w = getattr(self, "_presampled_w", None)
        presampled_b = getattr(self, "_presampled_b", None)
        num_draws = getattr(self, "_mc_draws", None)
        if num_draws:
            # all S draws: the presampled (S, ...) perturbations, or one
            # sampler launch on a zero mean
            if presampled_w is not None:
                delta, pert_b = presampled_w, presampled_b
            else:
                delta, pert_b = self._sample_draws(
                    num_draws, self.mu_kernel, self.rho_kernel,
                    zero_mean=True)
            return conv_ops.flipout_conv_draws(
                input, self.mu_kernel, self.mu_bias, delta, pert_b,
                self._sign_salts(num_draws), **self._conv_args())
        if presampled_w is not None:
            # this draw's perturbation from the batch sampler (parallel.mc)
            return conv_ops.flipout_conv_presampled(
                input, self.mu_kernel, self.mu_bias, presampled_w,
                presampled_b, self._sign_salts(), **self._conv_args())
        return conv_ops.flipout_conv(
            input, self.generator, self.mu_kernel, self.rho_kernel,
            self.mu_bias, self.rho_bias, eps_k=eps_k, eps_b=eps_b,
            sign_in=sign_in, sign_out=sign_out, **self._conv_args())

    @tracing.spanned("layer.bayes")
    def forward(self, input, return_kl: bool = True, *, eps_k=None,
                eps_b=None, sign_in=None, sign_out=None):
        if self.dnn_to_bnn_flag:
            return_kl = False

        presampled_w = getattr(self, "_presampled_w", None)
        num_draws = getattr(self, "_mc_draws", None)
        if self.quant_prepare:
            args = dict(self._conv_args(), compute_dtype=None)
            observed = self._observed_forward_flipout \
                if self.estimator == "flipout" else self._observed_forward
            out = observed(
                input, self.mu_kernel, self.rho_kernel,
                lambda x, w, b: conv_ops._apply_conv(x, w, b, **args))
        elif self.estimator == "flipout":
            out = self._forward_flipout(input, eps_k, eps_b, sign_in,
                                        sign_out)
        elif num_draws:
            # all S draws: the presampled (S, ...) stack, or one launch
            if presampled_w is not None:
                w, b = presampled_w, getattr(self, "_presampled_b", None)
            else:
                w, b = self._sample_draws(num_draws, self.mu_kernel,
                                          self.rho_kernel)
            out = conv_ops.conv_draws(input, w, b, **self._conv_args())
        elif presampled_w is not None:
            # this draw's kernel from the batch sampler (parallel.mc)
            out = conv_ops._apply_conv(input, presampled_w,
                                       getattr(self, "_presampled_b", None),
                                       **self._conv_args())
        else:
            out = conv_ops.sampled_conv(
                input, self.generator, self.mu_kernel, self.rho_kernel,
                self.mu_bias, self.rho_bias, eps_k=eps_k, eps_b=eps_b,
                **self._conv_args())

        if return_kl:
            return out, self._kl_or_zero()
        return out

    def __repr__(self):
        return f"{type(self).__name__}()"
