"""K-F: the fused int8 GEMM + requantize (counterpart of
``bayesian_torch_tpu/ops/pallas/qmatmul.py``).

``qmatmul_requant(x_q, x_scale, x_zp, w_q, w_scale, bias, out_scale,
out_zp)`` takes uint8 x (M, K) and int8 w (N, K) and returns uint8 (M, N):

    acc[m, n] = sum_k x[m, k] * w[n, k]                         (exact)
    out[m, n] = clamp(round(f32(acc + corr[n]) * mult + b[n]) + out_zp,
                      0, 255)

with ``corr = -x_zp * colsum(w)`` (none when x_zp == 0), so ``acc + corr``
is the exact ``sum_k (x - x_zp) * w``, ``mult = x_scale * w_scale *
(1/out_scale)`` and ``b = bias * (1/out_scale)``, computed here in the
order of the JAX ``qlinear`` (``requant_args``). That is the epilogue of
the JAX default (XLA) route, not the folded ``beta`` of the Pallas kernel,
so the CUDA kernel (``csrc/qmatmul.cu``), its plain version below and the
JAX default route agree bit for bit.

A CPU tensor takes the plain version: the integer product as a float64
matmul (exact: |acc| <= 255*128*K < 2**53), then the same f32 epilogue. A
CUDA tensor launches the kernel or raises. The kernel's tensor maps need K
a multiple of 16 and 16-byte aligned operands: a K off that grid is padded
with zero columns (a zero weight adds nothing; ``ops.int8.qconv`` builds
its patches that wide), an operand off that alignment is copied.

``qmatmul_requant_flipout(..., epi)``: the same product with the Flipout
epilogue (the kernel's second instantiation): the requantized uint8 p goes
on through the rest of the INT8 Flipout layer's chain, ``qadd(mean,
qmul(p, quantize_uint8(signs)))`` (``FlipoutEpilogue``), the signs hashed
from the GEMM's ``SignMap`` (``ops/cuda/flipout_signs.py``), the mean read
in the same pass. Its plain version is that chain in torch:
``qmatmul_requant_plain``, the sign product of K-H3's plain version on the
GEMM's signs, ``int8.qadd``. Its own ``launches`` count.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.ops.cuda.flipout_signs import f32, sign_uint8
from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import _on_cpu
from bayesian_torch_tpu_torch.utils import tracing


def requant_multiplier(x_scale, w_scale, out_scale) -> float:
    """``x_scale * w_scale * (1/out_scale)`` rounded to f32, as JAX
    evaluates it: in Python floats for static scales, or in f32 steps when
    ``w_scale`` is an f32 scalar (a frozen draw's scale, held in JAX as an
    f32 array). Returned as the Python float of that f32 value."""
    inv = 1.0 / out_scale
    if isinstance(w_scale, np.float32):
        m = np.float32(np.float32(x_scale) * w_scale) * np.float32(inv)
    else:
        m = x_scale * w_scale * inv
    return float(np.float32(m))


def requant_args(w_q, x_zp, x_scale, w_scale, bias_f32, out_scale):
    """(corr int32 (N,) or None, mult float, b f32 (N,) or None): the
    epilogue's integer correction, multiplier and scaled bias."""
    corr = None
    if x_zp != 0:
        corr = -int(x_zp) * w_q.sum(dim=1, dtype=torch.int32)
    b = None
    if bias_f32 is not None:
        b = bias_f32.float() * (1.0 / out_scale)
    return corr, requant_multiplier(x_scale, w_scale, out_scale), b


def qmatmul_requant_plain(x_q, w_q, corr, mult, b, out_zp):
    """Plain torch version of K-F on the epilogue's arguments."""
    acc = x_q.double() @ w_q.double().T
    if corr is not None:
        acc = acc + corr.double()
    out = acc.float() * mult
    if b is not None:
        out = out + b
    q = torch.round(out) + out_zp
    return torch.clamp(q, 0, 255).to(torch.uint8)


def _check(x_q, w_q, corr, b):
    if x_q.dtype != torch.uint8 or w_q.dtype != torch.int8:
        raise ValueError(f"need x uint8 and w int8; got {x_q.dtype} and "
                         f"{w_q.dtype}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"need x (M, K) and w (N, K); got x "
                         f"{tuple(x_q.shape)}, w {tuple(w_q.shape)}")
    n = w_q.shape[0]
    for name, t, dtype in (("corr", corr, torch.int32),
                           ("bias", b, torch.float32)):
        if t is not None and (t.dtype != dtype or tuple(t.shape) != (n,)):
            raise ValueError(f"need {name} {dtype} ({n},); got {t.dtype} "
                             f"{tuple(t.shape)}")


def _launch(x_q, w_q, corr, mult, b, out_zp, epi=None):
    """K-F into a new (M, N) uint8 tensor; with ``epi`` (an ``_Epilogue``)
    its Flipout instantiation."""
    from bayesian_torch_tpu_torch.ops.cuda import _build

    tensors = [t for t in (x_q, w_q, corr, b) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("qmatmul_requant: x, w, corr and bias must be "
                         "contiguous")
    K = x_q.shape[1]
    if K % 16:
        pad = (0, 16 - K % 16)
        x_q, w_q = F.pad(x_q, pad), F.pad(w_q, pad)
    x_q, w_q = (t if t.data_ptr() % 16 == 0 else t.clone()
                for t in (x_q, w_q))
    lib = _build.load_library()
    M, K = x_q.shape
    N = w_q.shape[0]
    out = torch.empty((M, N), dtype=torch.uint8, device=x_q.device)
    args = (x_q.data_ptr(), w_q.data_ptr(),
            None if corr is None else corr.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), M, N, K,
            mult, out_zp)
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if epi is None:
            code = lib.btt_qmatmul_requant(*args, stream)
        else:
            code = lib.btt_qmatmul_requant_flipout(
                *args, ctypes.addressof(epi), stream)
    if epi is None:
        _build.check(lib, code, "qmatmul_requant")
        qmatmul_requant.launches += 1
    else:
        _build.check(lib, code, "qmatmul_requant_flipout")
        qmatmul_requant_flipout.launches += 1
    return out


@tracing.launch_counter
@tracing.spanned("kernel.qmatmul_requant")
def qmatmul_requant(x_q, x_scale, x_zp, w_q, w_scale, bias_f32, out_scale,
                    out_zp):
    """uint8 x (M, K) @ int8 w (N, K)^T -> requantized uint8 (M, N), with
    the semantics of the JAX ``qlinear`` (round half to even, clamp to
    [0, 255]); the s32 accumulator never reaches device memory."""
    corr, mult, b = requant_args(w_q, x_zp, x_scale, w_scale, bias_f32,
                                 out_scale)
    _check(x_q, w_q, corr, b)
    if _on_cpu(*(t for t in (x_q, w_q, b) if t is not None)):
        return qmatmul_requant_plain(x_q, w_q, corr, mult, b, out_zp)
    return _launch(x_q, w_q, corr, mult, b, float(out_zp))


class FlipoutEpilogue(NamedTuple):
    """The INT8 Flipout layer's chain after its perturbation product p (at
    the GEMM's out_scale and out_zp): ``out = qadd(mean, qmul(p,
    quantize_uint8(signs, sign_scale, sign_zp)))``, the product at
    (prod_scale, prod_zp), the sum at (out_scale, out_zp), as
    ``ops/int8.py`` rounds them. ``mean`` is the uint8 output of the
    layer's mean product, (M, N) at a GEMM (rows at any stride, unit
    column stride); ``signs`` the layer's ``flipout_signs.OutputSigns``,
    of which the GEMM writes lane ``lane``'s channels from ``ch0``."""

    mean: torch.Tensor
    mean_scale: float
    mean_zp: float
    signs: object
    sign_scale: float
    sign_zp: float
    prod_scale: float
    prod_zp: float
    out_scale: float
    out_zp: float
    lane: int = 0
    ch0: int = 0


class _Epilogue(ctypes.Structure):
    """``BttFlipEpilogue`` of ``csrc/qmatmul.cu``."""

    _fields_ = [("mean", ctypes.c_void_p), ("ld_mean", ctypes.c_int64),
                ("salt", ctypes.c_uint32), ("c0", ctypes.c_uint32),
                ("cb", ctypes.c_uint32), ("cr", ctypes.c_uint32),
                ("cn", ctypes.c_uint32), ("R", ctypes.c_int32),
                ("p_zp", ctypes.c_int32), ("pos", ctypes.c_int32),
                ("neg", ctypes.c_int32), ("m_sign", ctypes.c_float),
                ("prod_zp", ctypes.c_float), ("mean_zp", ctypes.c_float),
                ("a_mean", ctypes.c_float), ("a_prod", ctypes.c_float),
                ("out_zp", ctypes.c_float)]


def qmatmul_requant_flipout_plain(x_q, w_q, corr, mult, b, out_zp, p_scale,
                                  epi):
    """Plain torch version of K-F with the Flipout epilogue: K-F's plain
    version, then the chain of ``layers/quantized_base.py``'s torch route
    on the GEMM's signs (``quantize_uint8``, ``qmul``, ``qadd``)."""
    from bayesian_torch_tpu_torch.ops import int8 as q

    p = qmatmul_requant_plain(x_q, w_q, corr, mult, b, out_zp)
    signs = epi.signs.gemm_plain(epi.lane, epi.ch0, p.shape[1], p.device)
    sign_q = q.quantize_uint8(signs, epi.sign_scale, epi.sign_zp)
    p2 = q.qmul(p, p_scale, sign_q, epi.sign_scale, epi.prod_scale,
                epi.prod_zp, a_zp=out_zp, b_zp=epi.sign_zp,
                out_dtype=torch.uint8)
    return q.qadd(epi.mean, epi.mean_scale, p2, epi.prod_scale,
                  epi.out_scale, epi.out_zp, a_zp=epi.mean_zp,
                  b_zp=epi.prod_zp, out_dtype=torch.uint8)


def _epilogue(epi, p_scale, p_zp, M, N):
    """The kernel's ``_Epilogue`` for ``epi`` after a product at (p_scale,
    p_zp): the scalars rounded to f32 as torch takes them into the chain's
    f32 ops, the GEMM's sign map."""
    mean = epi.mean
    if mean.dtype != torch.uint8 or tuple(mean.shape) != (M, N) or \
            mean.stride(1) != 1:
        raise ValueError(f"qmatmul_requant_flipout: need the mean uint8 "
                         f"({M}, {N}) with unit column stride; got "
                         f"{mean.dtype} {tuple(mean.shape)} stride "
                         f"{mean.stride()}")
    sm = epi.signs.sign_map(epi.lane, epi.ch0)
    pos, neg = sign_uint8(epi.sign_scale, epi.sign_zp)
    b_zp = int(epi.sign_zp)
    inv = 1.0 / epi.out_scale
    e = _Epilogue()
    e.mean, e.ld_mean = mean.data_ptr(), mean.stride(0) if M > 1 else N
    e.salt, e.c0, e.cb, e.cr, e.cn, e.R = sm
    e.p_zp, e.pos, e.neg = int(p_zp), pos - b_zp, neg - b_zp
    e.m_sign = f32(p_scale * epi.sign_scale * (1.0 / epi.prod_scale))
    e.prod_zp, e.mean_zp = f32(epi.prod_zp), f32(epi.mean_zp)
    e.a_mean = f32(epi.mean_scale * inv)
    e.a_prod = f32(epi.prod_scale * inv)
    e.out_zp = f32(epi.out_zp)
    return e


@tracing.launch_counter
@tracing.spanned("kernel.qmatmul_requant_flipout")
def qmatmul_requant_flipout(x_q, x_scale, x_zp, w_q, w_scale, bias_f32,
                            out_scale, out_zp, epi):
    """``qmatmul_requant`` (the perturbation's product, requantized to
    out_scale, out_zp) with the Flipout epilogue ``epi``: returns the
    layer's uint8 (M, N) output ``qadd(epi.mean, qmul(p, signs))``; p and
    the signed p never reach device memory."""
    corr, mult, b = requant_args(w_q, x_zp, x_scale, w_scale, bias_f32,
                                 out_scale)
    _check(x_q, w_q, corr, b)
    if _on_cpu(*(t for t in (x_q, w_q, b, epi.mean) if t is not None)):
        return qmatmul_requant_flipout_plain(x_q, w_q, corr, mult, b,
                                             out_zp, out_scale, epi)
    e = _epilogue(epi, out_scale, out_zp, x_q.shape[0], w_q.shape[0])
    return _launch(x_q, w_q, corr, mult, b, float(out_zp), e)
