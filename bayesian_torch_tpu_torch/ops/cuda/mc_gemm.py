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
"""

from __future__ import annotations

import torch

from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import _on_cpu

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


def mc_gemm(x, w, bias=None):
    """Per-draw GEMM: ``w (S, O, C)``, ``bias (S, O)`` or None, ``x (B, S,
    C, P)`` or shared ``(B, C, P)`` -> ``(B, S, O, P)``. Differentiable in
    x, w and bias."""
    if w.dim() != 3:
        raise ValueError(f"mc_gemm: need w (S, O, C); got {tuple(w.shape)} "
                         "(one weight for all draws is pointwise_gemm)")
    return _run(x, w, bias, mc_gemm)


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


mc_gemm.launches = 0  # K-G launches of either direction, from any caller
pointwise_gemm.launches = 0
