"""INT8 quantized ops (counterpart of ``bayesian_torch_tpu/ops/int8.py``).

Conventions, as in the JAX package and the reference:

- weights: symmetric per-tensor int8, zero point 0, scale
  ``2 * clamp(max|x|, 0, 100) / 255`` (``default_scale`` when all zero);
- activations: affine uint8 (zero point usually 128);
- bias: f32, never quantized.

Rounding follows the JAX functions exactly: quantizers multiply by the
reciprocal of the scale, ``torch.round`` rounds half to even as
``jnp.round`` does, values are clamped before the cast, and a multiplier
built from Python floats is one f32 multiply (torch casts a Python scalar
to the tensor's dtype, as JAX does with a weakly typed scalar).

``qlinear`` and ``qconv`` are one route: the fused int8 GEMM + requantize
of ``ops/cuda/qmatmul.py`` (K-F on CUDA tensors, its plain version on CPU
tensors). A 1x1 conv is a strided slice and the GEMM; a spatial conv is a
uint8 im2col into the same GEMM, padded with the activation zero point so
padded taps add nothing (the JAX package's opt-in im2col route, whose value
equals its default XLA conv route), its rows widened to a multiple of 16
bytes with zero weight columns (the stem's 147 to 160). Activations keep their NCHW shape; a
conv's output is the GEMM's (B*Ho*Wo, O) result viewed as NCHW, so its
memory is channels-last and the next conv's im2col reads it without a
transpose.

A grouped conv is one GEMM per group over that group's channels (K =
C/g * prod(k), widened to 16), the groups' outputs side by side (``cat``). A transposed conv is the stride-1 conv of
its flipped, regrouped kernel over the input with stride - 1 positions
inserted between neighbours and d*(k-1)-p added at each edge
(``output_padding`` more at the far edge), as the JAX package lowers it.
Every inserted and added position holds the zero point, so it adds
``w * (x_zp - x_zp) = 0`` and the sum runs over the real taps alone: the
JAX route's border-exact correction, and its value.

``flipout=`` (a ``qmatmul.FlipoutEpilogue``, the mean in the output's
layout): the INT8 Flipout layer's perturbation product with the rest of
its chain, ``qadd(mean, qmul(pert, quantize_uint8(signs)))``, through K-F's
Flipout epilogue, each GEMM reading its own columns of the mean and
hashing its own block of the signs.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.ops.conv import channels_last
from bayesian_torch_tpu_torch.ops.cuda.qmatmul import (
    FlipoutEpilogue,
    qmatmul_requant,
    qmatmul_requant_flipout,
)


def symmetric_scale(x, upper_bound=100.0, target_range=255.0,
                    default_scale=0.1):
    """Reference scale rule: 2*clamp(max|x|, 0, upper)/range, 0 -> default.
    Returns an f32 0-d tensor on x's device."""
    xmax = torch.clamp(x.abs().max().float(), 0.0, upper_bound)
    scale = xmax * 2.0 / target_range
    return torch.where(scale == 0, torch.full_like(scale, default_scale),
                       scale)


def quantize_int8(x, scale):
    """Symmetric int8 (zero point 0): round(x * (1/scale)), clamped."""
    q = torch.round(x * (1.0 / scale))
    return torch.clamp(q, -128, 127).to(torch.int8)


def quantize_uint8(x, scale, zero_point):
    q = torch.round(x * (1.0 / scale)) + zero_point
    return torch.clamp(q, 0, 255).to(torch.uint8)


def dequantize(q, scale, zero_point=0):
    return (q.float() - zero_point) * scale


def requantize_int8(acc_f32, out_scale, out_zp=0):
    q = torch.round(acc_f32 * (1.0 / out_scale)) + out_zp
    return torch.clamp(q, -128, 127).to(torch.int8)


def _clip_range(dtype):
    return (0, 255) if dtype == torch.uint8 else (-128, 127)


def qmul(a_q, a_scale, b_q, b_scale, out_scale, out_zp=0, *, a_zp=0,
         b_zp=0, out_dtype=torch.int8):
    """torch.ops.quantized.mul equivalent:
    clamp(round(a_deq * b_deq / out_scale) + out_zp). The centred operands
    are widened to int32 first, so nothing wraps."""
    a_c = a_q.to(torch.int32) - int(a_zp)
    b_c = b_q.to(torch.int32) - int(b_zp)
    prod = (a_c * b_c).float() * (a_scale * b_scale * (1.0 / out_scale))
    lo, hi = _clip_range(out_dtype)
    q = torch.round(prod) + out_zp
    return torch.clamp(q, lo, hi).to(out_dtype)


def qadd(a_q, a_scale, b_q, b_scale, out_scale, out_zp=0, *, a_zp=0,
         b_zp=0, out_dtype=torch.int8):
    """torch.ops.quantized.add equivalent."""
    inv = 1.0 / out_scale
    s = ((a_q.float() - a_zp) * (a_scale * inv)
         + (b_q.float() - b_zp) * (b_scale * inv))
    lo, hi = _clip_range(out_dtype)
    q = torch.round(s) + out_zp
    return torch.clamp(q, lo, hi).to(out_dtype)


def qlinear(x_q, x_scale, x_zp, w_q, w_scale, bias_f32, out_scale, out_zp,
            flipout=None):
    """uint8 activation (..., K) x int8 weight (N, K) -> uint8 (..., N),
    requantized to (out_scale, out_zp), through the fused GEMM; with
    ``flipout`` (its mean (..., N)), the Flipout layer's output."""
    lead = x_q.shape[:-1]
    args = (x_q.reshape(-1, x_q.shape[-1]).contiguous(), x_scale, x_zp,
            w_q.contiguous(), w_scale, bias_f32, out_scale, out_zp)
    n = w_q.shape[0]
    if flipout is None:
        out = qmatmul_requant(*args)
    else:
        out = qmatmul_requant_flipout(
            *args, flipout._replace(mean=flipout.mean.reshape(-1, n)))
    return out.reshape(tuple(lead) + (n,))


def _ntuple(v, n):
    return (int(v),) * n if isinstance(v, int) else tuple(int(u) for u in v)


def _zp_padded(xl, x_zp, lo, hi):
    """(B, *sp, C) with ``lo[i]`` / ``hi[i]`` positions of ``x_zp`` added
    before / after spatial dim i (a negative count crops)."""
    pad = []
    for a, b in zip(reversed(lo), reversed(hi)):
        pad += [a, b]
    if any(pad):
        return F.pad(xl, [0, 0] + pad, value=int(x_zp))
    return xl


def _taps(xl, x_zp, k, st, pd, dl):
    """The conv's input patches of (B, *sp, C) as a list of strided views,
    one (B, *out_sp, C) per kernel tap in (*k) order, and ``out_sp``."""
    nd = len(k)
    if all(ki == 1 for ki in k) and all(p == 0 for p in pd):
        tap = xl[(slice(None),) + tuple(slice(None, None, s) for s in st)]
        return [tap], tuple(tap.shape[1:-1])
    xp = _zp_padded(xl, x_zp, pd, pd)
    out_sp = tuple((xp.shape[1 + i] - dl[i] * (k[i] - 1) - 1) // st[i] + 1
                   for i in range(nd))
    taps = []
    for offs in itertools.product(*(range(ki) for ki in k)):
        taps.append(xp[(slice(None),) + tuple(
            slice(offs[i] * dl[i],
                  offs[i] * dl[i] + st[i] * (out_sp[i] - 1) + 1, st[i])
            for i in range(nd))])
    return taps, out_sp


def _group_gemm(taps, x_scale, x_zp, w_q, w_scale, bias_f32, out_scale,
                out_zp, flipout=None):
    """One group's conv as the GEMM: the taps' channels side by side
    ((*k, C) order) widened with zero columns to a multiple of 16 bytes
    (K-F's tensor maps), against the kernel (O, C, *k) in the same order
    -> (M, O) uint8 (with ``flipout``, the group's Flipout output)."""
    nd = w_q.dim() - 2
    kdim = len(taps) * taps[0].shape[-1]
    kpad = -kdim % 16
    parts = list(taps)
    if kpad:
        parts.append(taps[0].new_zeros(()).expand(
            tuple(taps[0].shape[:-1]) + (kpad,)))
    patches = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    w2 = w_q.permute(0, *range(2, nd + 2), 1).reshape(w_q.shape[0], -1)
    if kpad:
        w2 = F.pad(w2, (0, kpad))
    return qlinear(patches.reshape(-1, kdim + kpad), x_scale, x_zp, w2,
                   w_scale, bias_f32, out_scale, out_zp, flipout)


def _transposed_as_conv(xl, w_q, x_zp, st, pd, op, dl, groups):
    """A transposed conv's equivalent stride-1 conv: (B, *sp, C) with
    st - 1 positions of ``x_zp`` between neighbours and d*(k-1)-p added at
    each edge (+ op at the far one), and the kernel (I, O/g, *k) regrouped
    to (O, I/g, *k) and flipped."""
    nd = len(st)
    k = tuple(w_q.shape[2:])
    if any(s > 1 for s in st):
        sp = xl.shape[1:-1]
        dil = xl.new_full((xl.shape[0],) + tuple(
            (sp[i] - 1) * st[i] + 1 for i in range(nd)) + (xl.shape[-1],),
            int(x_zp))
        dil[(slice(None),) + tuple(slice(None, None, s) for s in st)] = xl
        xl = dil
    lo = [dl[i] * (k[i] - 1) - pd[i] for i in range(nd)]
    xl = _zp_padded(xl, x_zp, lo, [lo[i] + op[i] for i in range(nd)])
    cin, og = w_q.shape[:2]
    w = w_q.reshape((groups, cin // groups, og) + k).transpose(1, 2)
    w = w.reshape((groups * og, cin // groups) + k)
    return xl, w.flip(tuple(range(2, nd + 2)))


def _group_flipout(flipout, last, groups, og):
    """The Flipout epilogue of each of ``groups`` GEMMs of ``og`` output
    channels: its columns of the mean, its lane and first channel of the
    signs (a group of the draw axis' S * g is lane s's group)."""
    if flipout is None:
        return [None] * groups
    mean = flipout.mean
    if not last:
        mean = mean.permute(0, *range(2, mean.dim()), 1)
    mean = mean.reshape(-1, mean.shape[-1])
    signs = flipout.signs
    per_lane = signs.block.shape[signs.channel_dim]
    return [flipout._replace(mean=mean[:, g * og:(g + 1) * og],
                             lane=g * og // per_lane, ch0=g * og % per_lane)
            for g in range(groups)]


def qconv(x_q, x_scale, x_zp, w_q, w_scale, bias_f32, out_scale, out_zp, *,
          stride=1, padding=0, dilation=1, groups=1, transposed=False,
          output_padding=0, data_format="NCHW", flipout=None):
    """uint8 activation (B, C, *sp) x int8 kernel -> uint8 (B, O, *out_sp),
    through the fused GEMM; the kernel is (O, C/g, *k), or (C, O/g, *k)
    when ``transposed``. ``data_format`` "NHWC" (any format ending in "C"):
    the activation is (B, *sp, C) and so is the output; the im2col reads it
    as it is. ``flipout``: the Flipout layer's output of this perturbation
    product (the mean laid out as the output).

    Exact at padded borders and at a transposed conv's inserted positions:
    they hold x_zp, so they add w * (x_zp - x_zp) = 0 and the result is
    the sum over the real taps of w * (x - x_zp), the JAX XLA route's
    value."""
    last = channels_last(data_format)
    nd = x_q.dim() - 2
    st, pd, dl = (_ntuple(v, nd) for v in (stride, padding, dilation))
    # (B, *sp, C): a view without copy when x_q is channels-last in memory
    xl = x_q if last else x_q.permute(0, *range(2, nd + 2), 1)
    if transposed:
        xl, w_q = _transposed_as_conv(xl, w_q, x_zp, st, pd,
                                      _ntuple(output_padding, nd), dl,
                                      groups)
        st, pd = (1,) * nd, (0,) * nd
    taps, out_sp = _taps(xl, x_zp, tuple(w_q.shape[2:]), st, pd, dl)
    cg, og = xl.shape[-1] // groups, w_q.shape[0] // groups
    epis = _group_flipout(flipout, last, groups, og)
    if groups == 1:
        out = _group_gemm(taps, x_scale, x_zp, w_q, w_scale, bias_f32,
                          out_scale, out_zp, epis[0])
    else:
        out = torch.cat([_group_gemm(
            [t[..., g * cg:(g + 1) * cg] for t in taps], x_scale, x_zp,
            w_q[g * og:(g + 1) * og], w_scale,
            None if bias_f32 is None else bias_f32[g * og:(g + 1) * og],
            out_scale, out_zp, epis[g]) for g in range(groups)], dim=1)
    out = out.reshape((x_q.shape[0],) + out_sp + (w_q.shape[0],))
    return out if last else out.permute(0, nd + 1, *range(1, nd + 1))
