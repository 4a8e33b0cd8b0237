"""Sampled and Flipout N-d convolution ops (counterpart of
``bayesian_torch_tpu/ops/conv.py``, the non-transposed branch; transposed
convolutions come in a later slice).

Kernels keep the torch layout (out_ch, in_ch // groups, *k) and
activations are NC* at the public surface. The convolutions themselves go
to ``torch.nn.functional.conv{1,2,3}d`` (cuDNN on the card), as the JAX
package leaves them to XLA: no Pallas convolution exists to port.

The pointwise emission is the exception (JAX ``CONV_1X1_DOT`` and
``_is_pointwise``): a 1x1, stride-1, unpadded, undilated, ungrouped conv is
a GEMM over the channel axis, and with ``pointwise_dot`` (default: the
module's ``CONV_1X1_DOT``, off) it goes to the hand-written per-draw GEMM
kernel (``ops/cuda/mc_gemm.py``) on a CUDA tensor and to that kernel's
plain version on a CPU tensor. The kernel has no backward, so the emission
is for inference; with an operand that requires grad it raises.

``conv_draws`` is the draw-axis form (JAX ``sampled_conv_structured``):
activations (B, S*C, *sp) carry draw s in channel block s, and the S
weight draws run as ONE conv, grouped S*groups ways, with no relayout of
the activations; a shared input (B, C, *sp) meets the S filter sets
stacked on the output channels. ``flipout_conv_draws`` is Flipout over
that axis (JAX ``flipout_conv_structured``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.ops.sampling import (cast_to, draw_seed,
                                                   flipout_combine,
                                                   rademacher_lanes,
                                                   sample_gaussian_delta,
                                                   sample_gaussian_weight,
                                                   sign_salts)

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}

# Process default of the pointwise emission (False, as in JAX); the
# per-call ``pointwise_dot`` overrides it. A set of (in_ch, out_ch) pairs
# restricts the emission to those shapes.
CONV_1X1_DOT = False


def _all(value, want):
    if isinstance(value, (tuple, list)):
        return all(v == want for v in value)
    return value == want


def _is_pointwise(w, stride, padding, dilation, groups, pointwise_dot):
    """Whether a conv with kernel ``w`` (O, I, *k) takes the pointwise
    emission. The JAX condition that activations are channels-last has no
    meaning here and is dropped: the kernel reads NC* as it is."""
    enable = CONV_1X1_DOT if pointwise_dot is None else pointwise_dot
    if not enable:
        return False
    if isinstance(enable, (set, frozenset)) and \
            (w.shape[1], w.shape[0]) not in enable:
        return False
    return (groups == 1 and all(k == 1 for k in w.shape[2:])
            and _all(stride, 1) and _all(dilation, 1)
            and not isinstance(padding, str) and _all(padding, 0))


def conv_nd(x, w, b=None, *, stride=1, padding=0, dilation=1, groups=1,
            compute_dtype=None, pointwise_dot=None):
    """torch.nn.functional.conv{1,2,3}d, in ``compute_dtype`` when one is
    given. ``padding`` may be 'SAME'/'VALID' as in the JAX op. A pointwise
    conv goes to the GEMM kernel when ``pointwise_dot`` (default
    ``CONV_1X1_DOT``) asks for it."""
    if isinstance(padding, str):
        padding = padding.lower()
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if _is_pointwise(w, stride, padding, dilation, groups, pointwise_dot):
        from bayesian_torch_tpu_torch.ops.cuda.mc_gemm import pointwise_gemm

        B, C = x.shape[:2]
        out = pointwise_gemm(
            x.reshape(B, C, -1).contiguous(),
            w.to(x.dtype).reshape(w.shape[:2]).contiguous(),
            None if b is None else b.to(x.dtype))
        return out.reshape((B, w.shape[0]) + tuple(x.shape[2:]))
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
               compute_dtype=None, pointwise_dot=None):
    """All S weight draws in one conv. ``w`` (S, O, I/groups, *k) and
    ``b`` (S, O) are the draws; ``x`` is (B, S*I, *sp) with draw s in
    channel block s, or (B, I, *sp) shared by the draws. Returns
    (B, S*O, *sp') with draw s in block s. A pointwise conv goes to the
    per-draw GEMM kernel when ``pointwise_dot`` (default ``CONV_1X1_DOT``)
    asks for it: x is read as (B, S, I, P) where it lies."""
    S, O = w.shape[:2]
    cin = w.shape[2] * groups
    if x.shape[1] in (cin, S * cin) and _is_pointwise(
            w[0], stride, padding, dilation, groups, pointwise_dot):
        from bayesian_torch_tpu_torch.ops.cuda.mc_gemm import mc_gemm

        if compute_dtype is not None:
            x = x.to(compute_dtype)
        B = x.shape[0]
        lanes = (B, cin, -1) if x.shape[1] == cin else (B, S, cin, -1)
        out = mc_gemm(x.reshape(lanes).contiguous(),
                      w.to(x.dtype).reshape(S, O, cin).contiguous(),
                      None if b is None else b.to(x.dtype))
        return out.reshape((B, S * O) + tuple(x.shape[2:]))
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


# How Flipout's mean and perturbation convs are emitted: "two" (separate
# convs, the JAX default), "fused" (one conv with doubled groups over
# concat([x, x * sign_in]) and concat([mu, delta])), or "tile", a steer
# for XLA's vmap with no meaning in eager PyTorch, which runs "two". The
# math is identical.
FLIPOUT_CONV_MODE = "two"
_FLIPOUT_MODES = ("two", "tile", "fused")


def _flipout_combined_conv(x, x_pert, mu_k, delta_k, mu_b, pert_bias, *,
                           stride, padding, dilation, groups,
                           compute_dtype):
    """One grouped conv for the mean and perturbation halves: inputs
    concat([x, x * sign_in]) on the channels, kernels concat([mu, delta])
    on the output channels, groups doubled, so the output channels split
    into [mean | pert]; biases are added to each half."""
    z = torch.cat([x, x_pert], dim=1)
    w_cat = torch.cat([mu_k, delta_k], dim=0)
    y = conv_nd(z, w_cat, None, stride=stride, padding=padding,
                dilation=dilation, groups=2 * groups,
                compute_dtype=compute_dtype)
    mean_half, pert_half = y.chunk(2, dim=1)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    if mu_b is not None:
        mean_half = mean_half + mu_b.to(y.dtype).reshape(bshape)
    if pert_bias is not None:
        pert_half = pert_half + pert_bias.to(y.dtype).reshape(bshape)
    return mean_half, pert_half


def flipout_conv(x, generator, mu_k, rho_k, mu_b=None, rho_b=None, *,
                 stride=1, padding=0, dilation=1, groups=1, eps_k=None,
                 eps_b=None, sign_in=None, sign_out=None, compute_dtype=None,
                 mode=None):
    """Flipout conv: mean conv + sign-flipped perturbation conv,

        conv(x, mu) + mu_b + sign_out * (conv(x * sign_in, sigma * eps)
                                         + sigma_b * eps_b).

    The mean conv carries ``mu_b``; the perturbation conv carries only
    ``sigma_b * eps_b``. Noise that is not injected is seeded from
    ``generator``: eps through the batch sampler's kernel on a zero mean,
    the signs from the counter hash (``rademacher_fused``), one salt each.
    """
    mode = mode or FLIPOUT_CONV_MODE
    if mode not in _FLIPOUT_MODES:
        raise ValueError(f"flipout_conv: unknown mode {mode!r} (expected "
                         f"one of {_FLIPOUT_MODES})")
    x, mu_k, rho_k, mu_b, rho_b, eps_k, eps_b = cast_to(
        compute_dtype, x, mu_k, rho_k, mu_b, rho_b, eps_k, eps_b)
    delta_k = sample_gaussian_delta(generator, mu_k, rho_k, eps_k)
    pert_bias = None
    if mu_b is not None:
        pert_bias = sample_gaussian_delta(generator, mu_b, rho_b, eps_b)
    salts = None
    if sign_in is None or sign_out is None:
        salts = sign_salts(draw_seed(generator))
    return _flipout_apply(
        x, mu_k, mu_b, delta_k, pert_bias, salts, sign_in, sign_out, mode,
        dict(stride=stride, padding=padding, dilation=dilation,
             groups=groups, compute_dtype=compute_dtype))


def _flipout_apply(x, mu_k, mu_b, delta_k, pert_bias, salts, sign_in,
                   sign_out, mode, args):
    def products(x, x_pert):
        if mode == "fused":
            return _flipout_combined_conv(x, x_pert, mu_k, delta_k, mu_b,
                                          pert_bias, **args)
        return (conv_nd(x, mu_k, mu_b, **args),
                conv_nd(x_pert, delta_k, pert_bias, **args))

    return flipout_combine(x, products, salts, sign_in, sign_out)


def flipout_conv_presampled(x, mu_k, mu_b, delta_k, pert_bias, salts, *,
                            stride=1, padding=0, dilation=1, groups=1,
                            compute_dtype=None):
    """Flipout conv of one draw whose perturbation ``delta_k = sigma * eps``
    (and ``pert_bias``) was drawn beforehand; the mean conv uses ``mu_k``
    and the signs come from ``salts``."""
    x, mu_k, mu_b, delta_k, pert_bias = cast_to(
        compute_dtype, x, mu_k, mu_b, delta_k, pert_bias)
    return _flipout_apply(
        x, mu_k, mu_b, delta_k, pert_bias, salts, None, None, "two",
        dict(stride=stride, padding=padding, dilation=dilation,
             groups=groups, compute_dtype=compute_dtype))


def flipout_conv_draws(x, mu_k, mu_b, delta, pert_bias, salts, *, stride=1,
                       padding=0, dilation=1, groups=1, compute_dtype=None):
    """Flipout over the draw axis (the JAX ``flipout_conv_structured`` and
    the vmapped ``flipout_conv``). ``x`` is (B, S*I, *sp) with draw s in
    channel block s, or (B, I, *sp) shared; ``delta`` (S, O, I/groups, *k)
    and ``pert_bias`` (S, O) are the draws of ``sigma * eps``; ``salts``
    holds each draw's ``sign_salts``. The mean conv has one kernel for all
    draws: the input viewed as (B*S, I, *sp), a free view since a draw's
    channels are contiguous per image, goes through one plain conv (once,
    for a shared input). The perturbation conv is ``conv_draws``. Lane s
    takes the signs a single forward of draw s takes under the same salts.
    Returns (B, S*O, *sp')."""
    x, mu_k, mu_b, delta, pert_bias = cast_to(
        compute_dtype, x, mu_k, mu_b, delta, pert_bias)
    S, O = delta.shape[:2]
    B = x.shape[0]
    cin = mu_k.shape[1] * groups
    sp = tuple(x.shape[2:])
    args = dict(stride=stride, padding=padding, dilation=dilation,
                groups=groups, compute_dtype=compute_dtype)
    sign_in = rademacher_lanes([a for a, _ in salts], (B, cin) + sp,
                               x.dtype, x.device)
    if x.shape[1] == cin:
        mean = conv_nd(x, mu_k, mu_b, **args)[:, None]
        x_pert = x[:, None] * sign_in
    elif x.shape[1] == S * cin:
        mean = conv_nd(x.reshape((B * S, cin) + sp), mu_k, mu_b, **args)
        mean = mean.reshape((B, S) + tuple(mean.shape[1:]))
        x_pert = x.reshape(sign_in.shape) * sign_in
    else:
        raise ValueError(f"conv over {S} draws: input has {x.shape[1]} "
                         f"channels, want {cin} (shared) or {S * cin} "
                         "(one block per draw)")
    pert = conv_draws(x_pert.reshape((B, S * cin) + sp), delta, pert_bias,
                      **args)
    sp_out = tuple(pert.shape[2:])
    sign_out = rademacher_lanes([b for _, b in salts], (B, O) + sp_out,
                                pert.dtype, pert.device)
    out = mean + pert.reshape((B, S, O) + sp_out) * sign_out
    return out.reshape((B, S * O) + sp_out)
