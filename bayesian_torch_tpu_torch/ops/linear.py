"""Sampled and Flipout linear ops (counterpart of
``bayesian_torch_tpu/ops/linear.py``). The fused kernel path lives in
``ops/cuda/sampled_matmul.py``.

``linear_draws`` is the draw-axis form (JAX ``sampled_linear_structured``):
features (..., S*K) carry draw s in block s; the product of each block with
its own weight draw is one batched ``torch.matmul``, left to the library
as the JAX package leaves it to XLA. ``flipout_linear_draws`` is Flipout
over that axis (JAX ``flipout_linear_structured``)."""

from __future__ import annotations

import torch.nn.functional as F

from bayesian_torch_tpu_torch.ops.sampling import (cast_to, draw_seed,
                                                   flipout_combine,
                                                   rademacher_lanes,
                                                   sample_gaussian_delta,
                                                   sample_gaussian_weight,
                                                   sign_salts)


def _linear(x, w, b=None, compute_dtype=None):
    """y = x @ w^T + b with torch-layout weight (out_features,
    in_features); in ``compute_dtype`` when one is given."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    out = F.linear(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def sampled_linear(x, generator, mu_w, rho_w, mu_b=None, rho_b=None, *,
                   eps_w=None, eps_b=None, compute_dtype=None):
    """Reparameterization linear: W and b sampled per call from
    ``generator`` (or from the injected eps). Returns the output only."""
    if compute_dtype is not None:
        # sample directly in the compute dtype, as the JAX op does
        mu_w, rho_w = mu_w.to(compute_dtype), rho_w.to(compute_dtype)
        if mu_b is not None:
            mu_b, rho_b = mu_b.to(compute_dtype), rho_b.to(compute_dtype)
        if eps_w is not None:
            eps_w = eps_w.to(compute_dtype)
        if eps_b is not None:
            eps_b = eps_b.to(compute_dtype)
    w, _ = sample_gaussian_weight(generator, mu_w, rho_w, eps=eps_w)
    b = None
    if mu_b is not None:
        b, _ = sample_gaussian_weight(generator, mu_b, rho_b, eps=eps_b)
    return _linear(x, w, b, compute_dtype)


def split_draws(x, num_samples, in_features):
    """(S, rows, K) lanes of ``x`` (..., S*K) with draw s in block s, or
    (rows, K) for ``x`` (..., K) shared by the draws."""
    if x.shape[-1] == in_features:
        return x.reshape(-1, in_features)
    if x.shape[-1] != num_samples * in_features:
        raise ValueError(f"linear over {num_samples} draws: input has "
                         f"{x.shape[-1]} features, want {in_features} "
                         f"(shared) or {num_samples * in_features} (one "
                         "block per draw)")
    return x.reshape(-1, num_samples, in_features).transpose(0, 1)


def join_draws(out, lead):
    """(S, rows, N) lanes back to (*lead, S*N), draw s in block s."""
    S, _, N = out.shape
    return out.transpose(0, 1).reshape(tuple(lead) + (S * N,))


def linear_draws(x, w, b=None, compute_dtype=None):
    """All S weight draws ``w`` (S, N, K), ``b`` (S, N) on ``x``
    (..., S*K) (draw s in block s) or (..., K) shared: (..., S*N)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    S, _, K = w.shape
    out = split_draws(x, S, K) @ w.to(x.dtype).transpose(1, 2)
    if b is not None:
        out = out + b.to(out.dtype)[:, None]
    return join_draws(out, x.shape[:-1])


def flipout_linear(x, generator, mu_w, rho_w, mu_b=None, rho_b=None, *,
                   eps_w=None, eps_b=None, sign_in=None, sign_out=None,
                   compute_dtype=None):
    """Flipout-estimator linear (Wen et al. 2018):

        (x @ mu^T + mu_b) + sign_out * ((x * sign_in) @ (sigma * eps)^T
                                        + sigma_b * eps_b)

    The mean bias rides the first product; only ``sigma_b * eps_b`` rides
    the perturbation; ``sign_in`` is shaped like x and ``sign_out`` like
    the output. Sampling and sign flips run in ``compute_dtype``. Noise
    that is not injected is seeded from ``generator``: eps through the
    batch sampler's kernel on a zero mean, the signs from the counter hash
    (``rademacher_fused``), one salt each."""
    x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b = cast_to(
        compute_dtype, x, mu_w, rho_w, mu_b, rho_b, eps_w, eps_b)
    delta_w = sample_gaussian_delta(generator, mu_w, rho_w, eps_w)
    pert_bias = None
    if mu_b is not None:
        pert_bias = sample_gaussian_delta(generator, mu_b, rho_b, eps_b)
    salts = None
    if sign_in is None or sign_out is None:
        salts = sign_salts(draw_seed(generator))
    return _flipout_apply(x, mu_w, mu_b, delta_w, pert_bias, salts, sign_in,
                          sign_out, compute_dtype)


def _flipout_apply(x, mu_w, mu_b, delta_w, pert_bias, salts, sign_in,
                   sign_out, compute_dtype):
    return flipout_combine(
        x, lambda x, x_pert: (_linear(x, mu_w, mu_b, compute_dtype),
                              _linear(x_pert, delta_w, pert_bias,
                                      compute_dtype)),
        salts, sign_in, sign_out)


def flipout_linear_presampled(x, mu_w, mu_b, delta_w, pert_bias, salts,
                              compute_dtype=None):
    """Flipout linear of one draw whose perturbation ``delta_w = sigma *
    eps`` (and ``pert_bias``) was drawn beforehand; the mean product uses
    ``mu_w`` and the signs come from ``salts``."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return _flipout_apply(x, mu_w, mu_b, delta_w, pert_bias, salts, None,
                          None, compute_dtype)


def flipout_linear_draws(x, mu_w, mu_b, delta, pert_bias, salts,
                         compute_dtype=None):
    """Flipout over the draw axis (JAX ``flipout_linear_structured``).
    ``x`` is (..., S*K) with draw s in block s, or (..., K) shared;
    ``delta`` (S, N, K) and ``pert_bias`` (S, N) are the draws of
    ``sigma * eps``; ``salts`` holds each draw's ``sign_salts``. The mean
    product shares ``mu_w`` across the draws; the perturbation is the
    per-draw batched product (``linear_draws``). Lane s takes the signs a
    single forward of draw s takes under the same salts. Returns
    (..., S*N)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    S, N, K = delta.shape
    lead = tuple(x.shape[:-1])
    if x.shape[-1] not in (K, S * K):
        raise ValueError(f"linear over {S} draws: input has {x.shape[-1]} "
                         f"features, want {K} (shared) or {S * K} (one "
                         "block per draw)")
    rows = x.reshape(-1, x.shape[-1])  # (R, K) or (R, S*K)
    R = rows.shape[0]
    sign_in = rademacher_lanes([a for a, _ in salts], lead + (K,), x.dtype,
                               x.device, axis=len(lead)).reshape(R, S, K)
    xs = rows[:, None] if x.shape[-1] == K else rows.reshape(R, S, K)
    mean = _linear(xs, mu_w, mu_b, compute_dtype)  # (R, 1 or S, N)
    pert = linear_draws((xs * sign_in).reshape(R, S * K), delta, pert_bias,
                        compute_dtype).reshape(R, S, N)
    sign_out = rademacher_lanes([b for _, b in salts], lead + (N,),
                                pert.dtype, pert.device, axis=len(lead),
                                output=True).reshape(R, S, N)
    return (mean + pert * sign_out).reshape(lead + (S * N,))
