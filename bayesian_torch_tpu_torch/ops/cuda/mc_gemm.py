"""K-G: the per-draw GEMM behind a pointwise convolution (counterpart of
``pallas_mc_gemm`` in ``benchmarks/bench_1x1_mc.py`` and of
``pallas_matmul`` in ``benchmarks/bench_mosaic_matmul.py``).

    y[b, s, o, p] = sum_c w[s, o, c] * x[b, s, c, p]   (+ bias[s, o])

in the port's own layout: activations NC* with draw s in channel block s,
viewed as x (B, S, C, P) with P = prod(spatial) contiguous, so a 1x1
stride-1 convolution over the draw axis needs no relayout on either side.
Accumulation is f32 (s32 for int8); bf16 and f32 come back in their own
type, int8 as int32. The bias is added in the output type after the cast,
as ``ops.conv.conv_nd`` adds it.

Two wrappers share the kernel (``csrc/mc_gemm.cu``), each with its own
launch count:

- ``mc_gemm(x, w, bias)``: per-draw weights ``w (S, O, C)``, ``bias (S,
  O)``, on ``x (B, S, C, P)`` or on a shared ``x (B, C, P)`` (a lane stride
  of 0, not a copy): ``(B, S, O, P)``;
- ``pointwise_gemm(x, w, bias)``: one weight ``w (O, C)``, ``bias (O,)``,
  on ``x (B, C, P)``: ``(B, O, P)``, the plain tiled GEMM batched over B.
  ``matmul(a, b)`` is its B = 1 case, ``(M, K) @ (K, N)``.

A CPU tensor takes the plain version (an f32 einsum; f64 for int8, where
it is exact). A CUDA tensor launches the kernel or raises.

Both float wrappers are differentiable (``_Gemm``): the input gradient is
K-G again, on the transposed weight, and counts on the same wrapper; the
weight and bias gradients are torch reductions over the batch and the
positions, as XLA takes the transpose of the JAX route's dot.

K-G channels-last (``csrc/mc_gemm_cl.cu``) is the same product on
channels-last activations, the layout ``_gemm_kernel`` reads, with M =
B*H*W rows and C contiguous:

    y[m, s, o] = sum_c x[m, s, c] * w[s, o, c]   (+ bias[s, o])

- ``mc_gemm_cl(x, w, bias)``: ``w (S, O, C)``, ``bias (S, O)``, on ``x (M,
  S, C)`` (an NHWC draw-axis activation (B, *sp, S*C) viewed without a
  copy) or on a shared ``x (M, C)`` (one GEMM against the S weights
  stacked on O): ``(M, S, O)``;
- ``pointwise_gemm_cl(x, w, bias)``: one weight ``w (O, C)``, ``bias (O,)``,
  on ``x (M, C)``: ``(M, O)``, the TPU ``_mm_kernel``'s (M, K) x (K, N).

bf16 and f32 only (the int8 GEMMs of the INT8 models are K-F). Both
operands are K-major, as wgmma takes them: x is read where it lies. A bf16
x whose rows or lanes are not a multiple of 8 elements apart (a tensor map
needs 16-byte strides) is copied with zero columns to the next multiple of
8 first; nothing else is copied. Both are differentiable (``_GemmCL``):
dx = g . w_s is the same kernel on the transposed weight (S, C, O),
counted on the same wrapper, dw and dbias torch reductions over M.
"""

from __future__ import annotations

import torch

from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import _on_cpu
from bayesian_torch_tpu_torch.utils import tracing

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def _operands(x, w, bias):
    """Validate and return ``(x4 (B, S or 1, C, P), w3 (S or 1, O, C), b2
    (S or 1, O) or None, S)``."""
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"need x and w both bfloat16, float32 or int8; got "
                         f"{x.dtype} and {w.dtype}")
    if w.dim() not in (2, 3) or x.dim() not in (3, 4):
        raise ValueError(f"need w (S, O, C) or (O, C) and x (B, S, C, P) or "
                         f"(B, C, P); got w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}")
    w3 = w if w.dim() == 3 else w[None]
    x4 = x if x.dim() == 4 else x[:, None]
    S = max(w3.shape[0], x4.shape[1])
    if w3.shape[0] not in (1, S) or x4.shape[1] not in (1, S) \
            or x4.shape[2] != w3.shape[2]:
        raise ValueError(f"w {tuple(w.shape)} and x {tuple(x.shape)} do not "
                         "agree in draws or channels")
    b2 = None
    if bias is not None:
        if x.dtype == torch.int8:
            raise ValueError("the int8 product takes no bias")
        b2 = bias if bias.dim() == 2 else bias[None]
        if tuple(b2.shape) != tuple(w3.shape[:2]):
            raise ValueError(f"need bias {tuple(w3.shape[:2])}; got "
                             f"{tuple(bias.shape)}")
    return x4, w3, b2, S


def _plain(x4, w3, b2, S):
    acc = torch.float64 if x4.dtype == torch.int8 else torch.float32
    out = torch.int32 if x4.dtype == torch.int8 else x4.dtype
    B, _, C, P = x4.shape
    y = torch.einsum("soc,bscp->bsop", w3.to(acc).expand(S, -1, -1),
                     x4.to(acc).expand(B, S, C, P)).to(out)
    if b2 is not None:
        y = y + b2.to(out)[None, :, :, None]
    return y


def _vec(t, row_elems):
    """Widest load in bytes (16, 8, 4, 2 or 1) that rows of ``row_elems``
    elements starting at ``t``'s base pointer allow."""
    row_bytes = row_elems * t.element_size()
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and t.data_ptr() % v == 0:
            return v
    return 1


def _aligned(t):
    """``t``, or a copy of it when its base is not 16-byte aligned (the
    tensor maps and the widest loads need it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x4, w3, b2, S):
    from bayesian_torch_tpu_torch.ops.cuda import _build

    if not (x4.is_contiguous() and w3.is_contiguous()):
        raise ValueError("mc_gemm: x and w must be contiguous")
    B, Sx, C, P = x4.shape
    Sw, O, _ = w3.shape
    if B * S > 65535 or -(-P // 64) > 65535:
        raise ValueError(f"mc_gemm: B * S = {B * S} lanes or P = {P} exceed "
                         "the launch grid (65535 lanes, 64 * 65535 positions)")
    out = torch.int32 if x4.dtype == torch.int8 else x4.dtype
    if b2 is not None:
        b2 = b2.detach().to(out).contiguous()
    w_row = C
    if x4.dtype == torch.bfloat16:
        # the weight's tensor map needs rows of a multiple of 16 bytes:
        # zero columns past C add nothing (x's rows past C load as 0)
        w_row = -(-C // 8) * 8
        w3 = _aligned(torch.nn.functional.pad(w3, (0, w_row - C))
                      if w_row != C else w3)
    y = torch.empty((B, S, O, P), dtype=out, device=x4.device)
    lib = _build.load_library()
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.btt_mc_gemm(
            x4.data_ptr(), w3.data_ptr(),
            None if b2 is None else b2.data_ptr(), y.data_ptr(),
            _DTYPE_CODES[x4.dtype], B, S, O, C, P, w_row, Sx * C * P,
            C * P if Sx == S and S > 1 else 0,
            O * w_row if Sw == S and S > 1 else 0,
            O if b2 is not None and b2.shape[0] == S and S > 1 else 0,
            _vec(x4, P), _vec(w3, w_row), stream)
    _build.check(lib, code, "mc_gemm")
    return y


def _apply(x4, w3, b2, S, counter):
    """One K-G product on CUDA tensors (counted on ``counter``), the plain
    version on CPU ones."""
    with tracing.kernel_span(counter):
        if _on_cpu(*(t for t in (x4, w3, b2) if t is not None)):
            return _plain(x4, w3, b2, S)
        y = _launch(x4, w3, b2, S)
        counter.launches += 1
        return y


class _Gemm(torch.autograd.Function):
    """K-G forward; backward ``dx[b, s] = w[s]^T g[b, s]`` through K-G on
    the transposed weight (one launch, counted on the same wrapper), and
    ``dw[s] = sum_{b,p} g[b, s] x[b, s]^T``, ``dbias = sum_{b,p} g`` as
    torch reductions (the JAX route leaves its transpose to XLA's dot,
    outside any Pallas kernel). A shared operand (a lane stride of 0) gets
    the sum over the draws."""

    @staticmethod
    def forward(ctx, x, w, bias, counter):
        x4, w3, b2, S = _operands(x, w, bias)
        ctx.counter = counter
        ctx.bias = None if bias is None else (bias.shape, bias.dtype)
        ctx.save_for_backward(x, w)
        return _apply(x4, w3, b2, S, counter)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x4, w3, _, S = _operands(x, w, None)
        B, Sx, C, P = x4.shape
        Sw, O, _ = w3.shape
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if Sx == S:
                wt = w3.transpose(1, 2).contiguous()  # (Sw, C, O)
                dx = _apply(g, wt, None, S, ctx.counter)
            else:
                # one input for all draws: sum over (s, o) as one product,
                # w (S, O, C) -> (C, S*O) on g viewed (B, 1, S*O, P)
                wt = w3.expand(S, O, C).permute(2, 0, 1).reshape(1, C, S * O)
                dx = _apply(g.reshape(B, 1, S * O, P), wt.contiguous(), None,
                            1, ctx.counter)
            dx = dx.reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("bsop,bscp->soc", g, x4.expand(B, S, C, P))
            if Sw == 1:
                dw = dw.sum(0, keepdim=True)
            dw = dw.reshape(w.shape).to(w.dtype)
        if ctx.needs_input_grad[2]:
            shape, dtype = ctx.bias
            db = g.float().sum((0, 3))
            if len(shape) == 1 or (shape[0] == 1 and S > 1):
                db = db.sum(0)
            db = db.reshape(shape).to(dtype)
        return dx, dw, db, None


def _run(x, w, bias, counter):
    if x.dtype == torch.int8:  # integer tensors carry no gradient
        return _apply(*_operands(x, w, bias), counter)
    return _Gemm.apply(x, w, bias, counter)


def mc_gemm_plain(x, w, bias=None):
    """Plain torch version of K-G for either wrapper's operands; always
    (B, S, O, P)."""
    return _plain(*_operands(x, w, bias))


@tracing.launch_counter  # K-G launches of either direction, from any caller
def mc_gemm(x, w, bias=None):
    """Per-draw GEMM: ``w (S, O, C)``, ``bias (S, O)`` or None, ``x (B, S,
    C, P)`` or shared ``(B, C, P)`` -> ``(B, S, O, P)``. Differentiable in
    x, w and bias."""
    if w.dim() != 3:
        raise ValueError(f"mc_gemm: need w (S, O, C); got {tuple(w.shape)} "
                         "(one weight for all draws is pointwise_gemm)")
    return _run(x, w, bias, mc_gemm)


@tracing.launch_counter
def pointwise_gemm(x, w, bias=None):
    """One weight for the whole batch: ``w (O, C)``, ``bias (O,)`` or None,
    ``x (B, C, P)`` -> ``(B, O, P)``. Differentiable in x, w and bias."""
    if w.dim() != 2 or x.dim() != 3:
        raise ValueError(f"pointwise_gemm: need w (O, C) and x (B, C, P); "
                         f"got w {tuple(w.shape)}, x {tuple(x.shape)}")
    return _run(x, w, bias, pointwise_gemm)[:, 0]


def matmul(a, b):
    """``(M, K) @ (K, N)`` through ``pointwise_gemm``: bf16 -> bf16 and
    f32 -> f32 with f32 accumulation, int8 -> int32."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul: need (M, K) and (K, N); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return pointwise_gemm(b[None], a)[0]


# --- K-G channels-last ---------------------------------------------------

_CL_CODES = {torch.bfloat16: 0, torch.float32: 1}


def _cl_operands(x, w, bias):
    """Validate and return ``(x3 (M, S or 1, C), w3 (S or 1, O, C), b2 (S
    or 1, O) or None, S)``."""
    if x.dtype != w.dtype or x.dtype not in _CL_CODES:
        raise ValueError(f"channels-last K-G: need x and w both bfloat16 or "
                         f"float32; got {x.dtype} and {w.dtype}")
    if w.dim() not in (2, 3) or x.dim() not in (2, 3):
        raise ValueError(f"channels-last K-G: need w (S, O, C) or (O, C) and "
                         f"x (M, S, C) or (M, C); got w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}")
    w3 = w if w.dim() == 3 else w[None]
    x3 = x if x.dim() == 3 else x[:, None]
    S = max(w3.shape[0], x3.shape[1])
    if w3.shape[0] not in (1, S) or x3.shape[1] not in (1, S) \
            or x3.shape[2] != w3.shape[2]:
        raise ValueError(f"w {tuple(w.shape)} and x {tuple(x.shape)} do not "
                         "agree in draws or channels")
    b2 = None
    if bias is not None:
        b2 = bias if bias.dim() == 2 else bias[None]
        if tuple(b2.shape) != tuple(w3.shape[:2]):
            raise ValueError(f"need bias {tuple(w3.shape[:2])}; got "
                             f"{tuple(bias.shape)}")
    return x3, w3, b2, S


def _plain_cl(x3, w3, b2, S):
    M, _, C = x3.shape
    y = torch.einsum("msc,soc->mso", x3.float().expand(M, S, C),
                     w3.float().expand(S, -1, -1)).to(x3.dtype)
    if b2 is not None:
        y = y + b2.to(x3.dtype)[None]
    return y


def _tma_ready(x3):
    """``x3`` as the bf16 tensor map takes it: C contiguous, rows and lanes
    16 bytes apart, the base 16-byte aligned; else a copy with zero
    columns to the next multiple of 8."""
    ok = (x3.stride(2) == 1 and x3.stride(0) % 8 == 0
          and (x3.shape[1] == 1 or x3.stride(1) % 8 == 0)
          and x3.data_ptr() % 16 == 0)
    if ok:
        return x3
    pad = -x3.shape[2] % 8
    return torch.nn.functional.pad(x3, (0, pad)) if pad else \
        _aligned(x3.contiguous())


def _launch_cl(x3, w3, b2, S):
    from bayesian_torch_tpu_torch.ops.cuda import _build

    M, Sx, C = x3.shape
    Sw, O, _ = w3.shape
    if Sx == 1 and S > 1:
        # one input for every draw: one GEMM against the S weights stacked
        # on the output channels, (M, S*O) = (M, S, O)
        y = _launch_cl(x3, w3.expand(S, O, C).reshape(1, S * O, C),
                       None if b2 is None else
                       b2.expand(S, O).reshape(1, S * O), 1)
        return y.reshape(M, S, O)
    if Sw == 1 and S > 1 and x3.is_contiguous():
        # one weight for every draw: the (M*S, C) rows are one GEMM
        return _launch_cl(x3.reshape(M * S, 1, C), w3, b2, 1).reshape(M, S, O)
    if x3.dtype == torch.bfloat16:
        x3 = _tma_ready(x3)
        w_row = -(-C // 8) * 8
        w3 = _aligned(torch.nn.functional.pad(w3, (0, w_row - C)).contiguous()
                      if w_row != C else w3.contiguous())
    else:
        if x3.stride(2) != 1:
            x3 = x3.contiguous()
        w_row = C
        w3 = w3.contiguous()
    if b2 is not None:
        b2 = b2.detach().to(x3.dtype).contiguous()
    y = torch.empty((M, S, O), dtype=x3.dtype, device=x3.device)
    lanes = S > 1
    lib = _build.load_library()
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.btt_mc_gemm_cl(
            x3.data_ptr(), w3.data_ptr(),
            None if b2 is None else b2.data_ptr(), y.data_ptr(),
            _CL_CODES[x3.dtype], M, S, O, C, w_row, x3.stride(0),
            x3.stride(1) if lanes else 0,
            O * w_row if lanes and Sw == S else 0, S * O, O if lanes else 0,
            O if b2 is not None and lanes and b2.shape[0] == S else 0,
            int(O % 8 == 0), stream)
    _build.check(lib, code, "mc_gemm_cl")
    return y


def _apply_cl(x3, w3, b2, S, counter):
    """One channels-last K-G product on CUDA tensors (counted on
    ``counter``), the plain version on CPU ones: (M, S, O)."""
    with tracing.kernel_span(counter):
        if _on_cpu(*(t for t in (x3, w3, b2) if t is not None)):
            return _plain_cl(x3, w3, b2, S)
        y = _launch_cl(x3, w3, b2, S)
        counter.launches += 1
        return y


class _GemmCL(torch.autograd.Function):
    """Channels-last K-G forward, (M, S, O); backward ``dx[m, s] = g[m, s]
    w[s]`` through the same kernel on the transposed weight (S, C, O) (one
    launch, counted on the same wrapper; a shared x takes the sum over the
    draws as one product), ``dw[s] = sum_m g[m, s]^T x[m, s]`` and
    ``dbias = sum_m g`` as torch reductions."""

    @staticmethod
    def forward(ctx, x, w, bias, counter):
        x3, w3, b2, S = _cl_operands(x, w, bias)
        ctx.counter = counter
        ctx.bias = None if bias is None else (bias.shape, bias.dtype)
        ctx.save_for_backward(x, w)
        return _apply_cl(x3, w3, b2, S, counter)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x3, w3, _, S = _cl_operands(x, w, None)
        M, Sx, C = x3.shape
        Sw, O, _ = w3.shape
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if Sx == S:
                wt = w3.transpose(1, 2).contiguous()  # (Sw, C, O)
                dx = _apply_cl(g, wt, None, S, ctx.counter)
            else:
                # one input for all draws: the sum over (s, o) as one
                # product, g (M, 1, S*O) against w as (1, C, S*O)
                wt = w3.expand(S, O, C).reshape(S * O, C).t().contiguous()
                dx = _apply_cl(g.reshape(M, 1, S * O), wt[None], None, 1,
                               ctx.counter)
            dx = dx.reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("mso,msc->soc", g, x3.expand(M, S, C))
            if Sw == 1:
                dw = dw.sum(0, keepdim=True)
            dw = dw.reshape(w.shape).to(w.dtype)
        if ctx.needs_input_grad[2]:
            shape, dtype = ctx.bias
            db = g.float().sum(0)
            if len(shape) == 1 or (shape[0] == 1 and S > 1):
                db = db.sum(0)
            db = db.reshape(shape).to(dtype)
        return dx, dw, db, None


def mc_gemm_cl_plain(x, w, bias=None):
    """Plain torch version of channels-last K-G for either wrapper's
    operands; always (M, S, O)."""
    return _plain_cl(*_cl_operands(x, w, bias))


@tracing.launch_counter
def mc_gemm_cl(x, w, bias=None):
    """Per-draw GEMM on channels-last activations: ``w (S, O, C)``, ``bias
    (S, O)`` or None, ``x (M, S, C)`` or shared ``(M, C)`` -> ``(M, S,
    O)``. Differentiable in x, w and bias."""
    if w.dim() != 3:
        raise ValueError(f"mc_gemm_cl: need w (S, O, C); got "
                         f"{tuple(w.shape)} (one weight for all draws is "
                         "pointwise_gemm_cl)")
    return _GemmCL.apply(x, w, bias, mc_gemm_cl)


@tracing.launch_counter
def pointwise_gemm_cl(x, w, bias=None):
    """One weight on channels-last rows: ``w (O, C)``, ``bias (O,)`` or
    None, ``x (M, C)`` -> ``(M, O)``. Differentiable in x, w and bias."""
    if w.dim() != 2 or x.dim() != 2:
        raise ValueError(f"pointwise_gemm_cl: need w (O, C) and x (M, C); "
                         f"got w {tuple(w.shape)}, x {tuple(x.shape)}")
    return _GemmCL.apply(x, w, bias, pointwise_gemm_cl)[:, 0]
