"""Sampled and Flipout N-d convolution ops, plain and transposed
(counterpart of ``bayesian_torch_tpu/ops/conv.py``).

Kernels keep the torch layouts, whatever the activations' layout (JAX
``conv_nd``: "kernel layout stays OIHW"):

- Conv:          (out_ch, in_ch // groups, *k);
- ConvTranspose: (in_ch, out_ch // groups, *k), with ``output_padding``.

Activations are NC* (``data_format="NCHW"``, the default) or channels-last
(``"NHWC"``; any format ending in "C", as JAX's ``_dim_numbers`` reads it,
so "NWC" and "NDHWC" too): a channels-last op takes and returns (B, *sp,
C). It runs torch's NC* convolution on the permuted view (B, C, *sp),
whose memory is channels-last, so cuDNN takes it without a transpose and
gives its output in the same memory format; the view back is (B, *sp, C)
without a copy. The bias is added on the last axis.

The convolutions themselves go to ``torch.nn.functional.conv{1,2,3}d``
and ``conv_transpose{1,2,3}d`` (cuDNN on the card), as the JAX package
leaves them to XLA: no Pallas convolution exists to port.

The pointwise emission is the exception (JAX ``CONV_1X1_DOT`` and
``_is_pointwise``): a 1x1, stride-1, unpadded, undilated, ungrouped conv is
a GEMM over the channel axis, and with ``pointwise_dot`` (default: the
module's ``CONV_1X1_DOT``, off) it goes to a hand-written per-draw GEMM
kernel on a CUDA tensor and to that kernel's plain version on a CPU
tensor: under a channels-last format, JAX's condition, to K-G
channels-last (``ops/cuda/mc_gemm.py::mc_gemm_cl``, ``pointwise_gemm_cl``)
on the (M, C) rows as they lie; under NC*, where JAX keeps XLA's conv, to
K-G in the NC* layout (``mc_gemm``, ``pointwise_gemm``) on (B, C, P), which
the port has taken since it first had K-G. Both train (the input gradient
through the same kernel). Transposed convs never take it.

``conv_draws`` is the draw-axis form (JAX ``sampled_conv_structured``):
activations (B, S*C, *sp), or (B, *sp, S*C) channels-last, carry draw s in
channel block s, and the S weight draws run as ONE conv, grouped S*groups
ways, with no relayout of the activations; a shared input (B, C, *sp)
meets the S filter sets stacked on the output channels. A transposed
kernel's draws stack on its input-channel axis, (S*I, O/g, *k), so the
S*groups groups of one transposed conv take the input blocks in turn.
``flipout_conv_draws`` is Flipout over that axis (JAX
``flipout_conv_structured``). Under a channels-last format the layout is
JAX's structured one, (B, *sp, S*C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.ops.cuda.flipout_signs import (sign_combine,
                                                         sign_flip)
from bayesian_torch_tpu_torch.ops.sampling import (cast_to, draw_seed,
                                                   flipout_combine,
                                                   sample_gaussian_delta,
                                                   sample_gaussian_weight,
                                                   sign_block, sign_salts)

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


def channels_last(data_format: str) -> bool:
    """Whether ``data_format`` puts the channels last (JAX
    ``_dim_numbers``: the format ends in "C")."""
    return data_format.endswith("C")


def channel_axis(data_format: str) -> int:
    """The channel axis of an activation in ``data_format``."""
    return -1 if channels_last(data_format) else 1


def to_nc(x, data_format):
    """(B, *sp, C) -> the (B, C, *sp) view (no copy) under a channels-last
    format; ``x`` itself under NC*."""
    return x.movedim(-1, 1) if channels_last(data_format) else x


def from_nc(y, data_format):
    """The inverse view of ``to_nc``."""
    return y.movedim(1, -1) if channels_last(data_format) else y


def _pointwise_geometry(w, stride, padding, dilation, groups):
    """1x1 kernel, stride 1, no padding or dilation, one group: the conv is
    a GEMM over the channel axis."""
    return (groups == 1 and all(k == 1 for k in w.shape[2:])
            and _all(stride, 1) and _all(dilation, 1)
            and not isinstance(padding, str) and _all(padding, 0))


def _is_pointwise(w, stride, padding, dilation, groups, pointwise_dot,
                  data_format="NCHW"):
    """Whether a conv with kernel ``w`` (O, I, *k) takes the pointwise
    emission: to K-G channels-last under a channels-last ``data_format``
    (JAX's condition), to K-G in the NC* layout otherwise (module
    docstring)."""
    enable = CONV_1X1_DOT if pointwise_dot is None else pointwise_dot
    if not enable:
        return False
    if isinstance(enable, (set, frozenset)) and \
            (w.shape[1], w.shape[0]) not in enable:
        return False
    return _pointwise_geometry(w, stride, padding, dilation, groups)


def _add_bias(out, b, data_format="NCHW"):
    if b is None:
        return out
    if channels_last(data_format):
        return out + b.to(out.dtype)
    return out + b.to(out.dtype).reshape((1, -1) + (1,) * (out.dim() - 2))


def conv_nd(x, w, b=None, *, stride=1, padding=0, dilation=1, groups=1,
            compute_dtype=None, data_format="NCHW", pointwise_dot=None):
    """torch.nn.functional.conv{1,2,3}d, in ``compute_dtype`` when one is
    given, on NC* or channels-last activations (``data_format``; the kernel
    stays OIHW). ``padding`` may be 'SAME'/'VALID' as in the JAX op. A
    pointwise conv goes to a GEMM kernel when ``pointwise_dot`` (default
    ``CONV_1X1_DOT``) asks for it (module docstring)."""
    if isinstance(padding, str):
        padding = padding.lower()
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if _is_pointwise(w, stride, padding, dilation, groups, pointwise_dot,
                     data_format):
        from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

        w2 = w.to(x.dtype).reshape(w.shape[:2])
        b1 = None if b is None else b.to(x.dtype)
        if channels_last(data_format):
            out = kg.pointwise_gemm_cl(x.reshape(-1, x.shape[-1]), w2, b1)
            return out.reshape(tuple(x.shape[:-1]) + (w.shape[0],))
        B, C = x.shape[:2]
        out = kg.pointwise_gemm(x.reshape(B, C, -1).contiguous(),
                                w2.contiguous(), b1)
        return out.reshape((B, w.shape[0]) + tuple(x.shape[2:]))
    out = _CONV[x.dim() - 2](to_nc(x, data_format), w.to(x.dtype), None,
                             stride, padding, dilation, groups)
    return _add_bias(from_nc(out, data_format), b, data_format)


def conv_transpose_nd(x, w, b=None, *, stride=1, padding=0,
                      output_padding=0, dilation=1, groups=1,
                      compute_dtype=None, data_format="NCHW"):
    """torch.nn.functional.conv_transpose{1,2,3}d with the kernel in the
    (in_ch, out_ch // groups, *k) layout, in ``compute_dtype`` when one is
    given, on NC* or channels-last activations. String padding is refused,
    as in the JAX op."""
    if isinstance(padding, str):
        raise ValueError("string padding is not supported for transposed "
                         "convolutions; pass explicit ints")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    out = _CONV_T[x.dim() - 2](to_nc(x, data_format), w.to(x.dtype), None,
                               stride, padding, output_padding, groups,
                               dilation)
    return _add_bias(from_nc(out, data_format), b, data_format)


def _apply_conv(x, w, b, transposed, *, stride, padding, output_padding,
                dilation, groups, compute_dtype, data_format="NCHW"):
    if transposed:
        return conv_transpose_nd(
            x, w, b, stride=stride, padding=padding,
            output_padding=output_padding, dilation=dilation, groups=groups,
            compute_dtype=compute_dtype, data_format=data_format)
    return conv_nd(x, w, b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups,
                   compute_dtype=compute_dtype, data_format=data_format)


def sampled_conv(x, generator, mu_k, rho_k, mu_b=None, rho_b=None, *,
                 stride=1, padding=0, output_padding=0, dilation=1,
                 groups=1, transposed=False, eps_k=None, eps_b=None,
                 compute_dtype=None, data_format="NCHW"):
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
                       groups=groups, compute_dtype=compute_dtype,
                       data_format=data_format)


def _channels(w, groups, transposed):
    """(in_ch, out_ch) of one kernel ``w`` in its layout."""
    if transposed:
        return w.shape[0], w.shape[1] * groups
    return w.shape[1] * groups, w.shape[0]


def _shared_input(x, S, cin, data_format="NCHW"):
    """Whether ``x`` is shared by the S draws (C = cin) or carries one
    channel block per draw (C = S*cin); raises otherwise."""
    c = x.shape[channel_axis(data_format)]
    if c not in (cin, S * cin):
        raise ValueError(f"conv over {S} draws: input has {c} channels, "
                         f"want {cin} (shared) or {S * cin} (one block per "
                         "draw)")
    return c == cin


def _tile_draws(x, S, data_format):
    """A shared input tiled to S channel blocks (a copy)."""
    reps = [1] * x.dim()
    reps[channel_axis(data_format)] = S
    return x.repeat(reps)


def _conv_transpose_draws(x, w, b, shared, *, groups, data_format, **args):
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
            x = _tile_draws(x, S, data_format)
        w = w.reshape((S * I,) + tuple(w.shape[2:]))
        g = S * groups
    return conv_transpose_nd(x, w, None if b is None else b.reshape(-1),
                             groups=g, data_format=data_format, **args)


def conv_draws(x, w, b=None, *, stride=1, padding=0, dilation=1, groups=1,
               compute_dtype=None, pointwise_dot=None, transposed=False,
               output_padding=0, data_format="NCHW"):
    """All S weight draws in one conv. ``w`` (S, O, I/groups, *k), or
    (S, I, O/groups, *k) when ``transposed``, and ``b`` (S, O) are the
    draws; ``x`` is (B, S*I, *sp) with draw s in channel block s, or
    (B, I, *sp) shared by the draws; channels-last, (B, *sp, S*I) or (B,
    *sp, I). Returns (B, S*O, *sp'), or (B, *sp', S*O), with draw s in
    block s. A pointwise conv goes to the per-draw GEMM kernel when
    ``pointwise_dot`` (default ``CONV_1X1_DOT``) asks for it: x is read as
    (B, S, I, P), or channels-last as (M, S, I), where it lies."""
    S = w.shape[0]
    cin, O = _channels(w[0], groups, transposed)
    shared = _shared_input(x, S, cin, data_format)
    if transposed:
        return _conv_transpose_draws(
            x, w, b, shared, groups=groups, stride=stride, padding=padding,
            output_padding=output_padding, dilation=dilation,
            compute_dtype=compute_dtype, data_format=data_format)
    if _is_pointwise(w[0], stride, padding, dilation, groups,
                     pointwise_dot, data_format):
        from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

        if compute_dtype is not None:
            x = x.to(compute_dtype)
        w3 = w.to(x.dtype).reshape(S, O, cin)
        b2 = None if b is None else b.to(x.dtype)
        if channels_last(data_format):
            lead = tuple(x.shape[:-1])
            rows = x.reshape((-1, cin) if shared else (-1, S, cin))
            return kg.mc_gemm_cl(rows, w3, b2).reshape(lead + (S * O,))
        B = x.shape[0]
        lanes = (B, cin, -1) if shared else (B, S, cin, -1)
        out = kg.mc_gemm(x.reshape(lanes).contiguous(), w3.contiguous(), b2)
        return out.reshape((B, S * O) + tuple(x.shape[2:]))
    if shared and groups > 1:
        # a shared grouped input: the groups of the stacked filters would
        # straddle the draws, so tile the input
        x = _tile_draws(x, S, data_format)
        shared = False
    # shared input: the S filter sets stack on the output channels
    g = groups if shared else S * groups
    w = w.reshape((S * O,) + tuple(w.shape[2:]))
    return conv_nd(x, w, None if b is None else b.reshape(S * O),
                   stride=stride, padding=padding, dilation=dilation,
                   groups=g, compute_dtype=compute_dtype,
                   data_format=data_format)


# How Flipout's mean and perturbation convs are emitted: "two" (separate
# convs, the JAX default), "fused" (one conv with doubled groups over
# concat([x, x * sign_in]) and concat([mu, delta])), or "tile", a steer
# for XLA's vmap with no meaning in eager PyTorch, which runs "two". The
# math is identical.
FLIPOUT_CONV_MODE = "two"
_FLIPOUT_MODES = ("two", "tile", "fused")


def _flipout_combined_conv(x, x_pert, mu_k, delta_k, mu_b, pert_bias,
                           transposed, *, groups, data_format="NCHW",
                           **args):
    """One grouped conv for the mean and perturbation halves: inputs
    concat([x, x * sign_in]) on the channels, kernels concat([mu, delta])
    on their first axis (output channels, or a transposed kernel's input
    channels), groups doubled, so the output channels split into
    [mean | pert]; biases are added to each half."""
    axis = channel_axis(data_format)
    z = torch.cat([x, x_pert], dim=axis)
    w_cat = torch.cat([mu_k, delta_k], dim=0)
    y = _apply_conv(z, w_cat, None, transposed, groups=2 * groups,
                    data_format=data_format, **args)
    mean_half, pert_half = y.chunk(2, dim=axis)
    return (_add_bias(mean_half, mu_b, data_format),
            _add_bias(pert_half, pert_bias, data_format))


def flipout_conv(x, generator, mu_k, rho_k, mu_b=None, rho_b=None, *,
                 stride=1, padding=0, output_padding=0, dilation=1,
                 groups=1, transposed=False, eps_k=None, eps_b=None,
                 sign_in=None, sign_out=None, compute_dtype=None,
                 data_format="NCHW", mode=None):
    """Flipout conv: mean conv + sign-flipped perturbation conv,

        conv(x, mu) + mu_b + sign_out * (conv(x * sign_in, sigma * eps)
                                         + sigma_b * eps_b),

    with ``conv`` the transposed conv when ``transposed``. The mean conv
    carries ``mu_b``; the perturbation conv carries only ``sigma_b *
    eps_b``. Noise that is not injected is seeded from ``generator``: eps
    through the batch sampler's kernel on a zero mean, the signs from the
    counter hash (``rademacher_fused``), one salt each, drawn inside the
    sign flip and the combine (K-H1 and K-H2 on a CUDA device), hashed over
    the input's and the output's shapes in ``data_format`` (under NHWC their
    (B, H, W, C) flat order, as in JAX, so an NHWC output is not the
    permuted NCHW one).
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
                         groups=groups, compute_dtype=compute_dtype,
                         data_format=data_format))


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
                            compute_dtype=None, data_format="NCHW"):
    """Flipout conv of one draw whose perturbation ``delta_k = sigma * eps``
    (and ``pert_bias``) was drawn beforehand; the mean conv uses ``mu_k``
    and the signs come from ``salts``."""
    x, mu_k, mu_b, delta_k, pert_bias = cast_to(
        compute_dtype, x, mu_k, mu_b, delta_k, pert_bias)
    return _flipout_apply(
        x, mu_k, mu_b, delta_k, pert_bias, salts, None, None, "two",
        transposed, dict(stride=stride, padding=padding,
                         output_padding=output_padding, dilation=dilation,
                         groups=groups, compute_dtype=compute_dtype,
                         data_format=data_format))


def flipout_conv_draws(x, mu_k, mu_b, delta, pert_bias, salts, *, stride=1,
                       padding=0, output_padding=0, dilation=1, groups=1,
                       transposed=False, compute_dtype=None,
                       data_format="NCHW"):
    """Flipout over the draw axis (the JAX ``flipout_conv_structured`` and
    the vmapped ``flipout_conv``). ``x`` is (B, S*I, *sp) with draw s in
    channel block s, or (B, I, *sp) shared; ``delta`` (S, *mu_k.shape)
    and ``pert_bias`` (S, O) are the draws of ``sigma * eps``; ``salts``
    holds each draw's ``sign_salts``. The mean conv has one kernel for all
    draws: the input viewed as (B*S, I, *sp), a free view since a draw's
    channels are contiguous per image, goes through one plain conv (once,
    for a shared input). The perturbation conv is ``conv_draws``. Lane s
    takes the signs a single forward of draw s takes under the same salts.
    Returns (B, S*O, *sp'). Channels-last: ``_flipout_draws_last``."""
    x, mu_k, mu_b, delta, pert_bias = cast_to(
        compute_dtype, x, mu_k, mu_b, delta, pert_bias)
    if channels_last(data_format):
        return _flipout_draws_last(
            x, mu_k, mu_b, delta, pert_bias, salts, transposed,
            dict(stride=stride, padding=padding,
                 output_padding=output_padding, dilation=dilation,
                 groups=groups, compute_dtype=compute_dtype,
                 data_format=data_format))
    S = delta.shape[0]
    B = x.shape[0]
    cin, O = _channels(mu_k, groups, transposed)
    sp = tuple(x.shape[2:])
    args = dict(stride=stride, padding=padding,
                output_padding=output_padding, dilation=dilation,
                groups=groups, compute_dtype=compute_dtype)
    if _shared_input(x, S, cin):
        mean = _apply_conv(x, mu_k, mu_b, transposed, **args)[:, None]
        xs = x[:, None]
    else:
        mean = _apply_conv(x.reshape((B * S, cin) + sp), mu_k, mu_b,
                           transposed, **args)
        mean = mean.reshape((B, S) + tuple(mean.shape[1:]))
        xs = x.reshape((B, S, cin) + sp)
    x_pert = sign_flip(xs, sign_block([a for a, _ in salts], (B, cin) + sp,
                                      axis=1))
    pert = conv_draws(x_pert.reshape((B, S * cin) + sp), delta, pert_bias,
                      transposed=transposed, **args)
    sp_out = tuple(pert.shape[2:])
    out = sign_combine(mean, pert.reshape((B, S, O) + sp_out), sign_block(
        [b for _, b in salts], (B, O) + sp_out, axis=1, output=True))
    return out.reshape((B, S * O) + sp_out)


def _flipout_draws_last(x, mu_k, mu_b, delta, pert_bias, salts, transposed,
                        args):
    """``flipout_conv_draws`` on channels-last activations: ``x`` (B, *sp,
    S*I), draw s in the last axis's block s, or (B, *sp, I) shared; returns
    (B, *sp', S*O). The mean conv has one kernel for all draws: a 1x1
    stride-1 conv runs once over the (B, *sp[:-1], sp[-1]*S, I) view (the
    draws side by side on the last spatial axis, a free view), any other
    conv as the S-way grouped conv of ``mu`` tiled S times (JAX
    ``flipout_conv_structured``); once for a shared input. The signs are
    lane s's ``rademacher_fused`` over (B, *sp, I) and (B, *sp', O) in that
    flat order, so lane s is what a single NHWC forward of draw s takes."""
    S = delta.shape[0]
    nd = x.dim() - 2
    B, sp = x.shape[0], tuple(x.shape[1:-1])
    cin, O = _channels(mu_k, args["groups"], transposed)
    if _shared_input(x, S, cin, args["data_format"]):
        mean = _apply_conv(x, mu_k, mu_b, transposed, **args)[..., None, :]
        xs = x[..., None, :]
    else:
        if not transposed and _pointwise_geometry(
                mu_k, args["stride"], args["padding"], args["dilation"],
                args["groups"]):
            side = x.reshape((B,) + sp[:-1] + (sp[-1] * S, cin))
            mean = _apply_conv(side, mu_k, mu_b, transposed, **args)
        else:
            mean = conv_draws(
                x, mu_k.expand((S,) + tuple(mu_k.shape)),
                None if mu_b is None else mu_b.expand(S, O),
                transposed=transposed, **args)
        xs = x.reshape((B,) + sp + (S, cin))
    x_pert = sign_flip(xs, sign_block([a for a, _ in salts],
                                      (B,) + sp + (cin,), axis=nd + 1))
    pert = conv_draws(x_pert.reshape((B,) + sp + (S * cin,)), delta,
                      pert_bias, transposed=transposed, **args)
    sp_out = tuple(pert.shape[1:-1])
    mean = mean.reshape((B,) + sp_out + (-1, O))
    out = sign_combine(mean, pert.reshape((B,) + sp_out + (S, O)),
                       sign_block([b for _, b in salts], (B,) + sp_out + (O,),
                                  axis=nd + 1, output=True))
    return out.reshape((B,) + sp_out + (S * O,))
