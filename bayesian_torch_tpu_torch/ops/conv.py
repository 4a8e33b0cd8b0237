"""Sampled and Flipout N-d convolution ops, plain and transposed
(counterpart of ``bayesian_torch_tpu/ops/conv.py``).

Kernels keep the torch layouts and activations are NC* at the public
surface:

- Conv:          (out_ch, in_ch // groups, *k);
- ConvTranspose: (in_ch, out_ch // groups, *k), with ``output_padding``.

The convolutions themselves go to ``torch.nn.functional.conv{1,2,3}d``
and ``conv_transpose{1,2,3}d`` (cuDNN on the card), as the JAX package
leaves them to XLA: no Pallas convolution exists to port.

The pointwise emission is the exception (JAX ``CONV_1X1_DOT`` and
``_is_pointwise``): a 1x1, stride-1, unpadded, undilated, ungrouped conv is
a GEMM over the channel axis, and with ``pointwise_dot`` (default: the
module's ``CONV_1X1_DOT``, off) it goes to the hand-written per-draw GEMM
kernel (``ops/cuda/mc_gemm.py``) on a CUDA tensor and to that kernel's
plain version on a CPU tensor. The kernel has no backward, so the emission
is for inference; with an operand that requires grad it raises. Transposed
convs never take it.

``conv_draws`` is the draw-axis form (JAX ``sampled_conv_structured``):
activations (B, S*C, *sp) carry draw s in channel block s, and the S
weight draws run as ONE conv, grouped S*groups ways, with no relayout of
the activations; a shared input (B, C, *sp) meets the S filter sets
stacked on the output channels. A transposed kernel's draws stack on its
input-channel axis, (S*I, O/g, *k), so the S*groups groups of one
transposed conv take the input blocks in turn. ``flipout_conv_draws`` is
Flipout over that axis (JAX ``flipout_conv_structured``).
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
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}

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


def _add_bias(out, b):
    if b is None:
        return out
    return out + b.to(out.dtype).reshape((1, -1) + (1,) * (out.dim() - 2))


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
    return _add_bias(out, b)


def conv_transpose_nd(x, w, b=None, *, stride=1, padding=0,
                      output_padding=0, dilation=1, groups=1,
                      compute_dtype=None):
    """torch.nn.functional.conv_transpose{1,2,3}d with the kernel in the
    (in_ch, out_ch // groups, *k) layout, in ``compute_dtype`` when one is
    given. String padding is refused, as in the JAX op."""
    if isinstance(padding, str):
        raise ValueError("string padding is not supported for transposed "
                         "convolutions; pass explicit ints")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    out = _CONV_T[x.dim() - 2](x, w.to(x.dtype), None, stride, padding,
                               output_padding, groups, dilation)
    return _add_bias(out, b)


def _apply_conv(x, w, b, transposed, *, stride, padding, output_padding,
                dilation, groups, compute_dtype):
    if transposed:
        return conv_transpose_nd(
            x, w, b, stride=stride, padding=padding,
            output_padding=output_padding, dilation=dilation, groups=groups,
            compute_dtype=compute_dtype)
    return conv_nd(x, w, b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups,
                   compute_dtype=compute_dtype)


def sampled_conv(x, generator, mu_k, rho_k, mu_b=None, rho_b=None, *,
                 stride=1, padding=0, output_padding=0, dilation=1,
                 groups=1, transposed=False, eps_k=None, eps_b=None,
                 compute_dtype=None):
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
    return _apply_conv(x, w, b, transposed, stride=stride, padding=padding,
                       output_padding=output_padding, dilation=dilation,
                       groups=groups, compute_dtype=compute_dtype)


def _channels(w, groups, transposed):
    """(in_ch, out_ch) of one kernel ``w`` in its layout."""
    if transposed:
        return w.shape[0], w.shape[1] * groups
    return w.shape[1] * groups, w.shape[0]


def _shared_input(x, S, cin):
    """Whether ``x`` is shared by the S draws (C = cin) or carries one
    channel block per draw (C = S*cin); raises otherwise."""
    if x.shape[1] not in (cin, S * cin):
        raise ValueError(f"conv over {S} draws: input has {x.shape[1]} "
                         f"channels, want {cin} (shared) or {S * cin} "
                         "(one block per draw)")
    return x.shape[1] == cin


def _conv_transpose_draws(x, w, b, shared, *, groups, **args):
    """``conv_draws`` of a transposed kernel: the draws (S, I, O/g, *k)
    stack on the input-channel axis and the S*groups groups take the
    input's blocks in turn. A shared input meets the draws stacked on the
    output channels, (I, S*O, *k), when groups == 1, and is tiled S times
    otherwise."""
    S, I = w.shape[:2]
    k = tuple(w.shape[3:])
    if shared and groups == 1:
        w = w.movedim(0, 1).reshape((I, S * w.shape[2]) + k)
        g = 1
    else:
        if shared:
            x = x.repeat((1, S) + (1,) * (x.dim() - 2))
        w = w.reshape((S * I,) + tuple(w.shape[2:]))
        g = S * groups
    return conv_transpose_nd(x, w, None if b is None else b.reshape(-1),
                             groups=g, **args)


def conv_draws(x, w, b=None, *, stride=1, padding=0, dilation=1, groups=1,
               compute_dtype=None, pointwise_dot=None, transposed=False,
               output_padding=0):
    """All S weight draws in one conv. ``w`` (S, O, I/groups, *k), or
    (S, I, O/groups, *k) when ``transposed``, and ``b`` (S, O) are the
    draws; ``x`` is (B, S*I, *sp) with draw s in channel block s, or
    (B, I, *sp) shared by the draws. Returns (B, S*O, *sp') with draw s
    in block s. A pointwise conv goes to the per-draw GEMM kernel when
    ``pointwise_dot`` (default ``CONV_1X1_DOT``) asks for it: x is read as
    (B, S, I, P) where it lies."""
    S = w.shape[0]
    cin, O = _channels(w[0], groups, transposed)
    shared = _shared_input(x, S, cin)
    if transposed:
        return _conv_transpose_draws(
            x, w, b, shared, groups=groups, stride=stride, padding=padding,
            output_padding=output_padding, dilation=dilation,
            compute_dtype=compute_dtype)
    if _is_pointwise(w[0], stride, padding, dilation, groups,
                     pointwise_dot):
        from bayesian_torch_tpu_torch.ops.cuda.mc_gemm import mc_gemm

        if compute_dtype is not None:
            x = x.to(compute_dtype)
        B = x.shape[0]
        lanes = (B, cin, -1) if x.shape[1] == cin else (B, S, cin, -1)
        out = mc_gemm(x.reshape(lanes).contiguous(),
                      w.to(x.dtype).reshape(S, O, cin).contiguous(),
                      None if b is None else b.to(x.dtype))
        return out.reshape((B, S * O) + tuple(x.shape[2:]))
    if shared and groups > 1:
        # a shared grouped input: the groups of the stacked filters would
        # straddle the draws, so tile the input
        x = x.repeat((1, S) + (1,) * (x.dim() - 2))
        shared = False
    # shared input: the S filter sets stack on the output channels
    g = groups if shared else S * groups
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


def _flipout_combined_conv(x, x_pert, mu_k, delta_k, mu_b, pert_bias,
                           transposed, *, groups, **args):
    """One grouped conv for the mean and perturbation halves: inputs
    concat([x, x * sign_in]) on the channels, kernels concat([mu, delta])
    on their first axis (output channels, or a transposed kernel's input
    channels), groups doubled, so the output channels split into
    [mean | pert]; biases are added to each half."""
    z = torch.cat([x, x_pert], dim=1)
    w_cat = torch.cat([mu_k, delta_k], dim=0)
    y = _apply_conv(z, w_cat, None, transposed, groups=2 * groups, **args)
    mean_half, pert_half = y.chunk(2, dim=1)
    return _add_bias(mean_half, mu_b), _add_bias(pert_half, pert_bias)


def flipout_conv(x, generator, mu_k, rho_k, mu_b=None, rho_b=None, *,
                 stride=1, padding=0, output_padding=0, dilation=1,
                 groups=1, transposed=False, eps_k=None, eps_b=None,
                 sign_in=None, sign_out=None, compute_dtype=None, mode=None):
    """Flipout conv: mean conv + sign-flipped perturbation conv,

        conv(x, mu) + mu_b + sign_out * (conv(x * sign_in, sigma * eps)
                                         + sigma_b * eps_b),

    with ``conv`` the transposed conv when ``transposed``. The mean conv
    carries ``mu_b``; the perturbation conv carries only ``sigma_b *
    eps_b``. Noise that is not injected is seeded from ``generator``: eps
    through the batch sampler's kernel on a zero mean, the signs from the
    counter hash (``rademacher_fused``), one salt each.
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
        transposed, dict(stride=stride, padding=padding,
                         output_padding=output_padding, dilation=dilation,
                         groups=groups, compute_dtype=compute_dtype))


def _flipout_apply(x, mu_k, mu_b, delta_k, pert_bias, salts, sign_in,
                   sign_out, mode, transposed, args):
    def products(x, x_pert):
        if mode == "fused":
            return _flipout_combined_conv(x, x_pert, mu_k, delta_k, mu_b,
                                          pert_bias, transposed, **args)
        return (_apply_conv(x, mu_k, mu_b, transposed, **args),
                _apply_conv(x_pert, delta_k, pert_bias, transposed, **args))

    return flipout_combine(x, products, salts, sign_in, sign_out)


def flipout_conv_presampled(x, mu_k, mu_b, delta_k, pert_bias, salts, *,
                            stride=1, padding=0, output_padding=0,
                            dilation=1, groups=1, transposed=False,
                            compute_dtype=None):
    """Flipout conv of one draw whose perturbation ``delta_k = sigma * eps``
    (and ``pert_bias``) was drawn beforehand; the mean conv uses ``mu_k``
    and the signs come from ``salts``."""
    x, mu_k, mu_b, delta_k, pert_bias = cast_to(
        compute_dtype, x, mu_k, mu_b, delta_k, pert_bias)
    return _flipout_apply(
        x, mu_k, mu_b, delta_k, pert_bias, salts, None, None, "two",
        transposed, dict(stride=stride, padding=padding,
                         output_padding=output_padding, dilation=dilation,
                         groups=groups, compute_dtype=compute_dtype))


def flipout_conv_draws(x, mu_k, mu_b, delta, pert_bias, salts, *, stride=1,
                       padding=0, output_padding=0, dilation=1, groups=1,
                       transposed=False, compute_dtype=None):
    """Flipout over the draw axis (the JAX ``flipout_conv_structured`` and
    the vmapped ``flipout_conv``). ``x`` is (B, S*I, *sp) with draw s in
    channel block s, or (B, I, *sp) shared; ``delta`` (S, *mu_k.shape)
    and ``pert_bias`` (S, O) are the draws of ``sigma * eps``; ``salts``
    holds each draw's ``sign_salts``. The mean conv has one kernel for all
    draws: the input viewed as (B*S, I, *sp), a free view since a draw's
    channels are contiguous per image, goes through one plain conv (once,
    for a shared input). The perturbation conv is ``conv_draws``. Lane s
    takes the signs a single forward of draw s takes under the same salts.
    Returns (B, S*O, *sp')."""
    x, mu_k, mu_b, delta, pert_bias = cast_to(
        compute_dtype, x, mu_k, mu_b, delta, pert_bias)
    S = delta.shape[0]
    B = x.shape[0]
    cin, O = _channels(mu_k, groups, transposed)
    sp = tuple(x.shape[2:])
    args = dict(stride=stride, padding=padding,
                output_padding=output_padding, dilation=dilation,
                groups=groups, compute_dtype=compute_dtype)
    sign_in = rademacher_lanes([a for a, _ in salts], (B, cin) + sp,
                               x.dtype, x.device)
    if _shared_input(x, S, cin):
        mean = _apply_conv(x, mu_k, mu_b, transposed, **args)[:, None]
        x_pert = x[:, None] * sign_in
    else:
        mean = _apply_conv(x.reshape((B * S, cin) + sp), mu_k, mu_b,
                           transposed, **args)
        mean = mean.reshape((B, S) + tuple(mean.shape[1:]))
        x_pert = x.reshape(sign_in.shape) * sign_in
    pert = conv_draws(x_pert.reshape((B, S * cin) + sp), delta, pert_bias,
                      transposed=transposed, **args)
    sp_out = tuple(pert.shape[2:])
    sign_out = rademacher_lanes([b for _, b in salts], (B, O) + sp_out,
                                pert.dtype, pert.device, output=True)
    out = mean + pert.reshape((B, S, O) + sp_out) * sign_out
    return out.reshape((B, S * O) + sp_out)
