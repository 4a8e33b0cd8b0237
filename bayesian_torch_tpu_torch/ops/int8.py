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
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.ops.cuda.qmatmul import qmatmul_requant


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


def qlinear(x_q, x_scale, x_zp, w_q, w_scale, bias_f32, out_scale, out_zp):
    """uint8 activation (..., K) x int8 weight (N, K) -> uint8 (..., N),
    requantized to (out_scale, out_zp), through the fused GEMM."""
    lead = x_q.shape[:-1]
    out = qmatmul_requant(x_q.reshape(-1, x_q.shape[-1]).contiguous(),
                          x_scale, x_zp, w_q.contiguous(), w_scale, bias_f32,
                          out_scale, out_zp)
    return out.reshape(tuple(lead) + (w_q.shape[0],))


def _ntuple(v, n):
    return (int(v),) * n if isinstance(v, int) else tuple(int(u) for u in v)


def qconv(x_q, x_scale, x_zp, w_q, w_scale, bias_f32, out_scale, out_zp, *,
          stride=1, padding=0, dilation=1, groups=1, transposed=False,
          data_format="NCHW"):
    """uint8 activation (B, C, *sp) x int8 kernel (O, C, *k) conv -> uint8
    (B, O, *out_sp), through the fused GEMM.

    Exact at padded borders: the padding holds x_zp, so padded taps add
    w * (x_zp - x_zp) = 0 and the result is the sum over valid taps of
    w * (x - x_zp), the JAX XLA route's value."""
    if groups != 1 or transposed or data_format != "NCHW":
        raise NotImplementedError(
            "qconv: grouped, transposed and channels-last quantized convs "
            "are not ported yet (ROADMAP Queue 1 #14); the port covers "
            "groups=1, NCHW, not transposed")
    nd = x_q.dim() - 2
    k = tuple(w_q.shape[2:])
    st, pd, dl = (_ntuple(v, nd) for v in (stride, padding, dilation))
    cin = x_q.shape[1]
    kdim = math.prod(k) * cin
    # the GEMM's rows are a multiple of 16 bytes (K-F's tensor maps): the
    # patches carry zero columns past kdim, the weight zero columns there
    kpad = -kdim % 16
    # (B, *sp, C): a view without copy when x_q is channels-last in memory
    xl = x_q.permute(0, *range(2, nd + 2), 1)
    if all(ki == 1 for ki in k) and all(p == 0 for p in pd):
        patches = xl[(slice(None),) + tuple(slice(None, None, s) for s in st)]
        out_sp = tuple(patches.shape[1:-1])
        if kpad:
            patches = F.pad(patches, (0, kpad))
    else:
        pad = []
        for p in reversed(pd):
            pad += [p, p]
        xp = F.pad(xl, [0, 0] + pad, value=int(x_zp))
        out_sp = tuple((xp.shape[1 + i] - dl[i] * (k[i] - 1) - 1) // st[i] + 1
                       for i in range(nd))
        taps = []
        for offs in itertools.product(*(range(ki) for ki in k)):
            taps.append(xp[(slice(None),) + tuple(
                slice(offs[i] * dl[i],
                      offs[i] * dl[i] + st[i] * (out_sp[i] - 1) + 1, st[i])
                for i in range(nd))])
        if kpad:
            taps.append(xp.new_zeros(()).expand(
                tuple(taps[0].shape[:-1]) + (kpad,)))
        patches = torch.cat(taps, dim=-1)  # (B, *out_sp, prod(k)*C + kpad)
    m = x_q.shape[0] * math.prod(out_sp)
    # w (O, C, *k) -> (O, (*k, C)) to match the patch order
    w2 = w_q.permute(0, *range(2, nd + 2), 1).reshape(w_q.shape[0], -1)
    if kpad:
        w2 = F.pad(w2, (0, kpad))
    out = qlinear(patches.reshape(m, kdim + kpad), x_scale, x_zp, w2,
                  w_scale, bias_f32, out_scale, out_zp)
    out = out.reshape((x_q.shape[0],) + out_sp + (w_q.shape[0],))
    return out.permute(0, nd + 1, *range(1, nd + 1))
