"""Sampled linear op (counterpart of ``bayesian_torch_tpu/ops/linear.py``,
reparameterization only; the Flipout ops come with the Flipout slice).
The fused kernel path lives in ``ops/cuda/sampled_matmul.py``.

``linear_draws`` is the draw-axis form (JAX ``sampled_linear_structured``):
features (..., S*K) carry draw s in block s; the product of each block with
its own weight draw is one batched ``torch.matmul``, left to the library
as the JAX package leaves it to XLA."""

from __future__ import annotations

import torch.nn.functional as F

from bayesian_torch_tpu_torch.ops.sampling import sample_gaussian_weight


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
