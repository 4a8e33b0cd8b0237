"""Base class and shared plumbing for variational layers (counterpart of
``bayesian_torch_tpu/layers/base_variational_layer.py``).

Layers are ``nn.Module``s whose posteriors are ``nn.Parameter``s and
whose priors are non-persistent buffers, so a ``state_dict`` holds the
same keys as the reference's (and as the JAX package's
``_torch_key_for``). Noise comes from an explicit CPU ``torch.Generator``
per layer, in place of ``nnx.Rngs``: it initialises the posterior and
then hands out one seed per forward call (``ops.sampling.draw_seed``).

Under ``mc_forward``'s vmap emission, ``_mc_draws`` (the draw count S) is
set on every module for the call: a layer that takes the draw axis
(``takes_draw_axis``) then sees activations with draw s in channel block
s and draws all S weight sets of the call at once (``_sample_draws``).
"""

from __future__ import annotations

import collections.abc
import threading
from itertools import repeat

import torch
from torch import nn

from bayesian_torch_tpu_torch.ops.kl import gaussian_kl
from bayesian_torch_tpu_torch.ops.sampling import (device_generator,
                                                   draw_seed,
                                                   rademacher_fused,
                                                   sigma_from_rho,
                                                   sign_salts,
                                                   window_kwargs,
                                                   window_lanes)


def get_kernel_size(x, n):
    """Normalise an int-or-iterable kernel spec to an n-tuple."""
    if isinstance(x, collections.abc.Iterable):
        return tuple(x)
    return tuple(repeat(x, n))


_default_seed_lock = threading.Lock()
_default_seed = [0]


def default_generator() -> torch.Generator:
    """A fresh CPU generator for a layer built without one.

    The reference's layers take no RNG argument (torch keeps its RNG state
    globally); to keep that constructor each such layer takes the next
    seed of a process-global counter, as the JAX ``default_rngs`` does.
    Pass ``generator=`` for reproducibility.
    """
    with _default_seed_lock:
        seed = _default_seed[0]
        _default_seed[0] += 1
    return torch.Generator().manual_seed(seed)


def seed_default_generator(seed: int) -> None:
    """Reset the process-global seed counter (test determinism helper)."""
    with _default_seed_lock:
        _default_seed[0] = seed


class BaseVariationalLayer(nn.Module):
    """Shared base for the Bayesian layers.

    ``dnn_to_bnn_flag``: when True, ``forward`` returns the bare output and
    the KL is collected out of band (``kl_loss`` / ``get_kl_loss``).
    ``compute_kl``: when False, ``forward`` returns kl = 0.0 without
    evaluating it (toggled by ``parallel.mc.mc_forward``).
    """

    def __init__(self):
        super().__init__()
        self.dnn_to_bnn_flag = False
        self.compute_kl = True
        # post-training quantization calibration: set by prepare(); the
        # forward then records activation and weight ranges
        self.quant_prepare = False

    def _make_observers(self, n_qint: int, n_quint: int, qconfig=None):
        """Build the calibration observers: ``n_qint`` from
        ``qconfig.weight`` (they watch weight-derived tensors: sigma, mu,
        eps, the sampled weight) and ``n_quint`` from
        ``qconfig.activation`` (input and output); per-tensor MinMax
        without a qconfig. As in the JAX package, each slot's dtype is
        checked (the quantized layers read ``quant_dict`` by position), so
        a swapped QConfig fails here."""
        from bayesian_torch_tpu_torch.quantization.observers import (
            MinMaxObserver,
        )
        wfac = qconfig.weight if qconfig is not None \
            else MinMaxObserver.with_args(dtype="qint8")
        afac = qconfig.activation if qconfig is not None \
            else MinMaxObserver.with_args(dtype="quint8")
        qint = [wfac() for _ in range(n_qint)]
        quint = [afac() for _ in range(n_quint)]
        for slot, want, which in ((qint, "qint8", "weight"),
                                  (quint, "quint8", "activation")):
            for ob in slot:
                got = getattr(ob, "dtype", None)
                if got != want:
                    raise ValueError(
                        f"QConfig.{which} built a {type(ob).__name__} with "
                        f"dtype={got!r}, but the {want} quant_dict slots "
                        f"require dtype={want!r}")
        device = next(self.parameters()).device
        self.qint_quant = nn.ModuleList(qint).to(device)
        self.quint_quant = nn.ModuleList(quint).to(device)
        self.quant_prepare = True

    def _observed_forward(self, input, mu, rho, apply):
        """Calibration forward in f32 (``apply(input, weight, bias)``),
        every intermediate observed: qint (sigma, mu, eps, sigma*eps,
        weight), quint (input, output). eps is drawn on the weights'
        device from a generator seeded by the layer's."""
        gen = device_generator(self.generator, mu.device)
        sigma = sigma_from_rho(rho)
        eps = torch.randn(mu.shape, generator=gen, device=mu.device)
        tmp_result = sigma * eps
        weight = mu + tmp_result
        bias = None
        if self.mu_bias is not None:
            eps_b = torch.randn(self.mu_bias.shape, generator=gen,
                                device=mu.device)
            bias = self.mu_bias + sigma_from_rho(self.rho_bias) * eps_b
        out = apply(input, weight, bias)
        self.quint_quant[0](input)
        self.quint_quant[1](out)
        for ob, v in zip(self.qint_quant, (sigma, mu, eps, tmp_result,
                                           weight)):
            ob(v)
        return out

    def _observed_forward_flipout(self, input, mu, rho, apply):
        """The Flipout calibration forward in f32, every intermediate
        observed: qint (sigma, mu, eps, delta), quint (input, outputs,
        sign_in, sign_out, x_tmp, pert_tmp, perturbed, out), the order the
        quantized layer's ``quant_dict`` reads (qint [2:] + quint). eps
        as in ``_observed_forward``, the signs from the counter hash."""
        gen = device_generator(self.generator, mu.device)
        sigma = sigma_from_rho(rho)
        eps = torch.randn(mu.shape, generator=gen, device=mu.device)
        delta = sigma * eps
        pert_bias = None
        if self.mu_bias is not None:
            eps_b = torch.randn(self.mu_bias.shape, generator=gen,
                                device=mu.device)
            pert_bias = sigma_from_rho(self.rho_bias) * eps_b
        outputs = apply(input, mu, self.mu_bias)
        salt_in, salt_out = self._sign_salts()
        sign_in = rademacher_fused(salt_in, input.shape, input.dtype,
                                   input.device)
        sign_out = rademacher_fused(salt_out, outputs.shape, outputs.dtype,
                                    outputs.device)
        x_tmp = input * sign_in
        pert_tmp = apply(x_tmp, delta, pert_bias)
        perturbed = pert_tmp * sign_out
        out = outputs + perturbed
        for ob, v in zip(self.quint_quant, (input, outputs, sign_in,
                                            sign_out, x_tmp, pert_tmp,
                                            perturbed, out)):
            ob(v)
        for ob, v in zip(self.qint_quant, (sigma, mu, eps, delta)):
            ob(v)
        return out

    def _sample_draws(self, num_samples, mu, rho, zero_mean=False):
        """All ``num_samples`` draws of the weight posterior (mu, rho) and
        of the bias, in the compute dtype, in ONE batch-sampler launch
        under one seed (weight and bias as one flat buffer): ``(w (S,
        *mu.shape), b (S, O) or None)``. With ``zero_mean`` the draws are
        the Flipout perturbations ``sigma * eps`` (the sampler runs on a
        zero mean). Differentiable (backward: one regenerate-eps
        launch). Under a mesh that splits the draws (``DrawWindow``) the S
        draws are this rank's lanes of the whole launch; a tensor-parallel
        shard (``parallel/tp.py``) draws its rows' windows of it."""
        from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
            sample_gaussian_batch,
        )
        dtype = self.compute_dtype or mu.dtype
        seed = draw_seed(self.generator)
        lane0, _ = window_lanes(num_samples)
        tp = getattr(self, "_tp", None)
        if tp is not None and tp.column:
            flat = tp.sample_draws(self, seed, mu, rho, num_samples, lane0,
                                   dtype, zero_mean)
        else:
            mu_flat, rho_flat = mu.reshape(-1), rho.reshape(-1)
            if self.mu_bias is not None:
                mu_flat = torch.cat([mu_flat, self.mu_bias])
                rho_flat = torch.cat([rho_flat, self.rho_bias])
            if zero_mean:
                mu_flat = torch.zeros_like(mu_flat)
            n = mu_flat.numel()
            flat = sample_gaussian_batch(seed, mu_flat, rho_flat,
                                         num_samples, dtype,
                                         **window_kwargs(lane0, n, 0, n))
        if self.mu_bias is None:
            return flat.reshape((num_samples,) + tuple(mu.shape)), None
        w, b = flat.split([mu.numel(), self.mu_bias.numel()], dim=1)
        return w.reshape((num_samples,) + tuple(mu.shape)), b

    def _sign_salts(self, num_draws=None):
        """The Flipout sign salts of this call: the pair(s) the presample
        attached (``_presampled_signs``: (2,) for one draw, (S, 2) under
        the draw axis), else fresh ones under one seed of the layer's
        generator. One (input, output) pair, or ``num_draws`` pairs (this
        rank's draws under a mesh that splits them). Salts on the device
        (a draw of a CUDA graph's loop, ``parallel/mc_graph.py``) come
        back as two one-element views, which K-H reads on the device:
        reading them on the host would wait for the card inside the
        capture."""
        signs = getattr(self, "_presampled_signs", None)
        if signs is not None:
            if signs.is_cuda:
                return signs[0:1], signs[1:2]
            salts = signs.tolist()
            return [tuple(p) for p in salts] if num_draws else tuple(salts)
        seed = draw_seed(self.generator)
        if num_draws:
            lane0, _ = window_lanes(num_draws)
            return [sign_salts(seed, s)
                    for s in range(lane0, lane0 + num_draws)]
        return sign_salts(seed)

    def kl_div(self, mu_q, sigma_q, mu_p, sigma_p):
        """KL(Q||P) between diagonal Gaussians, mean-reduced."""
        return gaussian_kl(mu_q, sigma_q, mu_p, sigma_p)

    def _init_posterior(self, shape, mu_init, rho_init, device=None,
                        dtype=torch.float32):
        """mu ~ N(mu_init, 0.1), rho ~ N(rho_init, 0.1), drawn on the CPU
        from the layer's generator and moved to ``device``."""
        def draw(init):
            t = init + 0.1 * torch.randn(shape, generator=self.generator,
                                         dtype=dtype)
            return nn.Parameter(t.to(device))

        return draw(mu_init), draw(rho_init)

    def _init_prior(self, mu_name, sigma_name, prior_mean, prior_variance,
                    device=None, dtype=torch.float32):
        """Scalar priors as non-persistent buffers. As in the reference,
        ``prior_variance`` is used as sigma_p in the KL."""
        self.register_buffer(mu_name, torch.tensor(prior_mean, dtype=dtype,
                                                   device=device),
                             persistent=False)
        self.register_buffer(sigma_name, torch.tensor(prior_variance,
                                                      dtype=dtype,
                                                      device=device),
                             persistent=False)

    def _no_bias(self):
        for name in ("mu_bias", "rho_bias"):
            self.register_parameter(name, None)
        for name in ("prior_bias_mu", "prior_bias_sigma"):
            self.register_buffer(name, None, persistent=False)

    def _kl_or_zero(self):
        return self.kl_loss() if self.compute_kl else 0.0


BaseVariationalLayer_ = BaseVariationalLayer
