"""Sampled N-d convolution op (counterpart of
``bayesian_torch_tpu/ops/conv.py``, reparameterization and the
non-transposed branch only; transposed and Flipout convolutions come in
later slices).

Kernels keep the torch layout (out_ch, in_ch // groups, *k) and
activations are NC* at the public surface. The convolutions themselves go
to ``torch.nn.functional.conv{1,2,3}d`` (cuDNN on the card), as the JAX
package leaves them to XLA: no Pallas convolution exists to port.

``conv_draws`` is the draw-axis form (JAX ``sampled_conv_structured``):
activations (B, S*C, *sp) carry draw s in channel block s, and the S
weight draws run as ONE conv, grouped S*groups ways, with no relayout of
the activations; a shared input (B, C, *sp) meets the S filter sets
stacked on the output channels.
"""

from __future__ import annotations

import torch.nn.functional as F

from bayesian_torch_tpu_torch.ops.sampling import sample_gaussian_weight

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_nd(x, w, b=None, *, stride=1, padding=0, dilation=1, groups=1,
            compute_dtype=None):
    """torch.nn.functional.conv{1,2,3}d, in ``compute_dtype`` when one is
    given. ``padding`` may be 'SAME'/'VALID' as in the JAX op."""
    if isinstance(padding, str):
        padding = padding.lower()
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    out = _CONV[x.dim() - 2](x, w.to(x.dtype), None, stride, padding,
                             dilation, groups)
    if b is not None:
        out = out + b.to(out.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))
    return out


def sampled_conv(x, generator, mu_k, rho_k, mu_b=None, rho_b=None, *,
                 stride=1, padding=0, dilation=1, groups=1, eps_k=None,
                 eps_b=None, compute_dtype=None):
    """Reparameterization conv: sample the kernel (and bias), convolve."""
    if compute_dtype is not None:
        # sample directly in the compute dtype, as the JAX op does
        mu_k, rho_k = mu_k.to(compute_dtype), rho_k.to(compute_dtype)
        if mu_b is not None:
            mu_b, rho_b = mu_b.to(compute_dtype), rho_b.to(compute_dtype)
        if eps_k is not None:
            eps_k = eps_k.to(compute_dtype)
        if eps_b is not None:
            eps_b = eps_b.to(compute_dtype)
    w, _ = sample_gaussian_weight(generator, mu_k, rho_k, eps=eps_k)
    b = None
    if mu_b is not None:
        b, _ = sample_gaussian_weight(generator, mu_b, rho_b, eps=eps_b)
    return conv_nd(x, w, b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups,
                   compute_dtype=compute_dtype)


def conv_draws(x, w, b=None, *, stride=1, padding=0, dilation=1, groups=1,
               compute_dtype=None):
    """All S weight draws in one conv. ``w`` (S, O, I/groups, *k) and
    ``b`` (S, O) are the draws; ``x`` is (B, S*I, *sp) with draw s in
    channel block s, or (B, I, *sp) shared by the draws. Returns
    (B, S*O, *sp') with draw s in block s."""
    S, O = w.shape[:2]
    cin = w.shape[2] * groups
    if x.shape[1] == cin and groups > 1:
        # a shared grouped input: the groups of the stacked filters would
        # straddle the draws, so tile the input
        x = x.repeat((1, S) + (1,) * (x.dim() - 2))
    if x.shape[1] == cin:
        # shared input: the S filter sets stack on the output channels
        g = groups
    elif x.shape[1] == S * cin:
        g = S * groups
    else:
        raise ValueError(f"conv over {S} draws: input has {x.shape[1]} "
                         f"channels, want {cin} (shared) or {S * cin} "
                         "(one block per draw)")
    w = w.reshape((S * O,) + tuple(w.shape[2:]))
    return conv_nd(x, w, None if b is None else b.reshape(S * O),
                   stride=stride, padding=padding, dilation=dilation,
                   groups=g, compute_dtype=compute_dtype)
