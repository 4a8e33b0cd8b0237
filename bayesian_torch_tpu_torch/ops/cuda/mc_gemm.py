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
it is exact). A CUDA tensor launches the kernel or raises. The kernel has
no backward: with grad enabled and an operand that requires grad both
wrappers raise on either device, and training keeps the library route.
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


def _refuse_grad(*tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the per-draw GEMM kernel (K-G) has no backward yet (ROADMAP.md "
            "Queue 1 #10): run inference under torch.no_grad() (mc_forward "
            "does so on a model in eval mode), and train through the "
            "library route (ops.conv.CONV_1X1_DOT = False, the default)")


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
    y = torch.empty((B, S, O, P), dtype=out, device=x4.device)
    lib = _build.load_library()
    with torch.cuda.device(x4.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.btt_mc_gemm(
            x4.data_ptr(), w3.data_ptr(),
            None if b2 is None else b2.data_ptr(), y.data_ptr(),
            _DTYPE_CODES[x4.dtype], B, S, O, C, P, Sx * C * P,
            C * P if Sx == S and S > 1 else 0,
            O * C if Sw == S and S > 1 else 0,
            O if b2 is not None and b2.shape[0] == S and S > 1 else 0,
            _vec(x4, P), _vec(w3, C), stream)
    _build.check(lib, code, "mc_gemm")
    return y


def _run(x, w, bias, counter):
    x4, w3, b2, S = _operands(x, w, bias)
    _refuse_grad(x, w, bias)
    if _on_cpu(*(t for t in (x, w, bias) if t is not None)):
        return _plain(x4, w3, b2, S)
    y = _launch(x4.detach(), w3.detach(), b2, S)
    counter.launches += 1
    return y


def mc_gemm_plain(x, w, bias=None):
    """Plain torch version of K-G for either wrapper's operands; always
    (B, S, O, P)."""
    return _plain(*_operands(x, w, bias))


def mc_gemm(x, w, bias=None):
    """Per-draw GEMM: ``w (S, O, C)``, ``bias (S, O)`` or None, ``x (B, S,
    C, P)`` or shared ``(B, C, P)`` -> ``(B, S, O, P)``."""
    if w.dim() != 3:
        raise ValueError(f"mc_gemm: need w (S, O, C); got {tuple(w.shape)} "
                         "(one weight for all draws is pointwise_gemm)")
    return _run(x, w, bias, mc_gemm)


def pointwise_gemm(x, w, bias=None):
    """One weight for the whole batch: ``w (O, C)``, ``bias (O,)`` or None,
    ``x (B, C, P)`` -> ``(B, O, P)``."""
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


mc_gemm.launches = 0
pointwise_gemm.launches = 0
