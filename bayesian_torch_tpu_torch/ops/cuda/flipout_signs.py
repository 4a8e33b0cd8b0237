"""K-H: the Flipout signs hashed inside the products that use them (no
Pallas counterpart: the JAX package's ``rademacher_fused``,
``bayesian_torch_tpu/ops/sampling.py:104``, is fused by XLA into the
multiply that consumes it, so its signs never reach memory).

Every wrapper takes a ``SignBlock`` (``ops/sampling.py``): lane s is the
block of ``shape`` at ``start`` of ``rademacher_fused(salts[s], whole)``,
the lanes on a dim inserted at ``axis``. An operand has the laid-out shape
(``block.lanes_shape``), or size 1 on the lane dim where it is shared
across the lanes (on no other dim). The salts are ints, or a 1-D int64
tensor on the operands' device, which K-H1 and K-H2 read when they run: a
launch captured into a CUDA graph (``parallel/mc_graph.py``) keeps its
geometry, so each replay takes the salts written into that tensor before
it. The plain versions take the same tensor.

- ``sign_flip(x, block)``: K-H1, ``x * signs`` in x's dtype (a flip of
  the sign bit); ``sign_flip(None, block, dtype, device)`` writes the
  signs themselves;
- ``sign_combine(mean, pert, block)``: K-H2, ``mean + pert * signs`` in
  their result dtype, the sum rounded once, as torch adds;
- ``qsign_mul(a_q, a_scale, a_zp, block, sign_scale, sign_zp, out_scale,
  out_zp)``: K-H3, the INT8 Flipout product ``qmul(a_q,
  quantize_uint8(signs))`` of ``ops/int8.py``, uint8 out; with
  ``requant=(scale, zp)``, ``a_q`` is a ``QTensor`` payload at that scale
  and zero point, first requantized to (a_scale, a_zp) as
  ``QTensor.requantize`` does, and the call returns that x_q beside the
  product (one read of the payload: the INT8 Flipout layer's input pass).

The output side's signs run in K-F's Flipout epilogue
(``ops/cuda/qmatmul.py::qmatmul_requant_flipout``), one GEMM at a time:
``OutputSigns`` holds a layer output's ``SignBlock`` and gives each GEMM
its ``SignMap``, the affine counter map of its (M, N) output, and, for the
plain versions, its slice of the block's plain signs (hashed once a
block).

Each keeps its plain torch version beside it (the counter hash of
``ops/sampling.py`` as a tensor, then the product), taken for CPU tensors
only, and a ``launches`` count; a CUDA tensor launches the kernel
(``csrc/flipout_signs.cu``) or raises. All three are bit for bit their
plain versions. The float ones are ``torch.autograd.Function``s that keep
the block alone and hash the signs again in backward: d(x * s)/dx = flip(g);
for the combine dmean = g and dpert = flip(g), summed over the lanes where
the operand is shared.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from typing import NamedTuple

from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import _on_cpu
from bayesian_torch_tpu_torch.ops.sampling import _M32, _hashes, _mix
from bayesian_torch_tpu_torch.utils import tracing

_DIMS, _LANES = 8, 256  # csrc/flipout_signs.cu BTT_SIGN_DIMS, _LANES
_FLOATS = {torch.float16: (16, 0x3C00), torch.bfloat16: (16, 0x3F80),
           torch.float32: (32, 0x3F800000),
           torch.float64: (64, 0x3FF0000000000000)}
_COMBINE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                  torch.float64: 3}


class _Geometry(ctypes.Structure):
    """``BttSignGeom`` of ``csrc/flipout_signs.cu``."""

    _fields_ = [("numel", ctypes.c_int64), ("base", ctypes.c_int64),
                ("size", ctypes.c_int64 * _DIMS),
                ("ctr", ctypes.c_int64 * _DIMS),
                ("lane", ctypes.c_int64 * _DIMS),
                ("y", ctypes.c_int64 * _DIMS), ("a", ctypes.c_int64 * _DIMS),
                ("b", ctypes.c_int64 * _DIMS), ("nd", ctypes.c_int32),
                ("lanes", ctypes.c_int32),
                ("salts", ctypes.c_uint32 * _LANES),
                ("lane_salts", ctypes.c_void_p),
                ("lane_salt_stride", ctypes.c_int64)]


def _whole_strides(whole):
    strides, acc = [], 1
    for n in reversed(whole):
        strides.append(acc)
        acc *= n
    return strides[::-1]


def _lane_counters(block):
    """(counter stride of each laid-out dim (0 on the lane dim), counter of
    the block's first element)."""
    wstr = _whole_strides(block.whole)
    ctr = list(wstr)
    if block.axis is not None:
        ctr.insert(block.axis, 0)
    return ctr, sum(s * w for s, w in zip(block.start, wstr))


# --- the plain versions -----------------------------------------------------


def _lane_signs(salt, block, dtype, device):
    """Lane ``salt``'s signs over ``block.shape``: one counter range where
    the block is a contiguous run of the whole, else each element's
    counter from its coordinates."""
    shape, whole, start = block.shape, block.whole, block.start
    n = math.prod(shape)
    wstr = _whole_strides(whole)
    base = sum(s * w for s, w in zip(start, wstr))
    lead = 0  # the dims before the first one narrower than the whole
    while lead < len(shape) and shape[lead] == 1:
        lead += 1
    if all(shape[d] == whole[d] for d in range(lead + 1, len(shape))):
        h = _hashes(salt, base, n, device)
    else:
        idx = torch.zeros((), dtype=torch.int64, device=device)
        for d in range(len(shape)):
            at = torch.arange(start[d], start[d] + shape[d],
                              dtype=torch.int64, device=device)
            idx = idx + (at * wstr[d]).reshape(
                (-1,) + (1,) * (len(shape) - 1 - d))
        h = _mix(salt, (idx + 1).reshape(-1))
    one = torch.ones((), dtype=dtype, device=device)
    return torch.where((h >> 31).bool(), -one, one).reshape(shape)


def signs_plain(block, dtype=torch.float32, device=None):
    """The laid-out signs of ``block`` in ``dtype``: the counter hash in
    torch, lane by lane."""
    lanes = [_lane_signs(salt, block, dtype, device) for salt in block.salts]
    if block.axis is None:
        return lanes[0]
    return torch.stack(lanes, dim=block.axis)


def sign_flip_plain(x, block):
    """Plain torch version of K-H1: ``x * signs`` in x's dtype."""
    return x * signs_plain(block, x.dtype, x.device)


def sign_combine_plain(mean, pert, block):
    """Plain torch version of K-H2: ``mean + pert * signs``, the signs in
    pert's dtype."""
    return mean + pert * signs_plain(block, pert.dtype, pert.device)


def sign_uint8(sign_scale, sign_zp):
    """(uint8 of +1, uint8 of -1) under ``quantize_uint8`` at (scale, zp),
    as ``ops/int8.py`` quantizes the sign tensors: round(+-f32(1/scale))
    + f32(zp) in f32, clamped to [0, 255]; worked out on the host, with
    no tensor."""
    r, zp = np.float32(1.0 / sign_scale), np.float32(sign_zp)
    return tuple(int(np.clip(np.round(v) + zp, 0, 255)) for v in (r, -r))


def qsign_mul_plain(a_q, a_scale, a_zp, block, sign_scale, sign_zp,
                    out_scale, out_zp, requant=None):
    """Plain torch version of K-H3: ``qmul(a_q, quantize_uint8(signs))``
    to uint8, the signs in f32 as the INT8 layers draw them; with
    ``requant`` (scale, zp), ``QTensor(a_q, *requant).requantize(a_scale,
    a_zp)`` first, laid out as the signs, returned beside the product."""
    from bayesian_torch_tpu_torch.ops import int8 as q
    from bayesian_torch_tpu_torch.ops.qtensor import QTensor

    x_q = a_q
    if requant is not None:
        x_q = QTensor(a_q, *requant).requantize(a_scale, a_zp).q
        x_q = x_q.expand(block.lanes_shape).clone()
    sign_q = q.quantize_uint8(signs_plain(block, torch.float32, a_q.device),
                              sign_scale, sign_zp)
    out = q.qmul(x_q, a_scale, sign_q, sign_scale, out_scale, out_zp,
                 a_zp=a_zp, b_zp=sign_zp, out_dtype=torch.uint8)
    return out if requant is None else (x_q, out)


class SignMap(NamedTuple):
    """The signs of a GEMM's (M, N) output as K-F's Flipout epilogue
    hashes them: element (m, n), m = b * R + r, takes bit 31 of
    splitmix32(salt + (c + 1) * GOLDEN) with c = c0 + b*cb + r*cr + n*cn
    mod 2**32."""

    salt: int
    c0: int
    cb: int
    cr: int
    cn: int
    R: int


class OutputSigns:
    """A layer output's signs as its GEMMs take them: ``block`` (one salt,
    or lanes on the output's channel dim) over an output whose per-lane
    shape ``block.shape`` holds its channels on ``channel_dim``; a GEMM
    writes lane ``lane``'s channels [ch0, ch0 + N) as (M, N), its rows the
    other dims in order. The plain signs of the whole block are hashed
    once, at the first GEMM that asks (``signs_plain``, as K-H3's plain
    version hashes a block)."""

    def __init__(self, block, channel_dim):
        self.block = block
        self.channel_dim = channel_dim % len(block.shape)
        self._plain = None

    def sign_map(self, lane, ch0):
        """The ``SignMap`` of the GEMM over lane ``lane``'s channels from
        ``ch0``. Every dim but the first and the channels' is whole (a
        window splits the rows, a shard or a group the channels)."""
        block, cd = self.block, self.channel_dim
        wstr = _whole_strides(block.whole)
        base = sum(s * w for s, w in zip(block.start, wstr))
        rows = [d for d in range(len(block.shape)) if d != cd]
        cb = wstr[rows[0]] if rows else 0
        cr = wstr[rows[-1]] if len(rows) > 1 else 0
        step = cr
        for d in reversed(rows[1:]):  # r steps the counter by cr
            if block.shape[d] != block.whole[d] or block.start[d] or \
                    wstr[d] != step:
                raise ValueError(f"signs {block}: the GEMM rows' dim {d} "
                                 "is not whole or not row-major past the "
                                 "first")
            step *= block.shape[d]
        R = math.prod(block.shape[d] for d in rows[1:])
        return SignMap(block.salts[lane] & _M32,
                       (base + ch0 * wstr[cd]) & _M32, cb & _M32, cr & _M32,
                       wstr[cd] & _M32, R)

    def gemm_plain(self, lane, ch0, n, device):
        """The f32 signs (M, n) of that GEMM: its slice of the block's
        plain signs."""
        if self._plain is None:
            self._plain = signs_plain(self.block, torch.float32, device)
        t = self._plain
        if self.block.axis is not None:
            t = t.select(self.block.axis, lane)
        cd = self.channel_dim
        t = t.narrow(cd, ch0, n).movedim(cd, -1)
        return t.reshape(-1, n).to(device)


# --- the kernels ------------------------------------------------------------


def _check_operand(t, block, name):
    """``t`` has the laid-out shape, or size 1 on the lane dim alone."""
    full = block.lanes_shape
    if t.dim() != len(full) or any(
            n != f and not (n == 1 and k == block.axis)
            for k, (n, f) in enumerate(zip(t.shape, full))):
        raise ValueError(f"{name} {tuple(t.shape)} does not lay out the "
                         f"signs {full} (size 1 only on the lane dim, "
                         "where it is shared)")


def _geometry(block, y, operands):
    """The launch's ``_Geometry``: the laid-out dims ordered by y's memory
    layout, innermost first, size-1 dims dropped and neighbours that step
    alike in the counter, the lane and every tensor merged."""
    ctr, base = _lane_counters(block)
    full = block.lanes_shape
    dims = []
    for k, n in enumerate(full):
        if n == 1:
            continue
        lane = int(block.axis is not None and k == block.axis)
        strides = [y.stride(k)] + [0 if t.shape[k] == 1 else t.stride(k)
                                   for t in operands]
        dims.append([n, ctr[k], lane, strides])
    dims.sort(key=lambda d: d[3][0], reverse=True)  # outermost first
    merged = []
    for n, c, lane, st in dims:
        if merged:
            pn, pc, pl, pst = merged[-1]
            if pc == n * c and pl == n * lane and all(
                    p == n * s for p, s in zip(pst, st)):
                merged[-1] = [pn * n, c, lane, st]
                continue
        merged.append([n, c, lane, st])
    if not merged:
        merged = [[1, 0, 0, [0] * (1 + len(operands))]]
    if len(merged) > _DIMS:
        raise ValueError(f"signs {full} take {len(merged)} dims after "
                         f"merging; the kernel takes {_DIMS}")
    g = _Geometry()
    g.numel, g.base, g.nd = math.prod(full), base, len(merged)
    for k, (n, c, lane, st) in enumerate(reversed(merged)):
        g.size[k], g.ctr[k], g.lane[k] = n, c, lane
        g.y[k] = st[0]
        g.a[k] = st[1] if len(st) > 1 else 0
        g.b[k] = st[2] if len(st) > 2 else 0
    g.lanes = len(block.salts)
    if torch.is_tensor(block.salts):
        salts = block.salts
        if salts.dtype != torch.int64 or salts.device != y.device:
            raise ValueError(f"salts of {salts.dtype} on {salts.device}: "
                             f"the kernel reads int64 on {y.device}")
        g.lane_salts, g.lane_salt_stride = salts.data_ptr(), salts.stride(0)
        return g
    for s, salt in enumerate(block.salts):
        g.salts[s] = salt & _M32
    return g


def _output(block, like, dtype, device):
    """The output: ``like``'s memory layout where it has the laid-out
    shape, else contiguous."""
    full = block.lanes_shape
    if like is not None and tuple(like.shape) == full:
        return torch.empty_like(like, dtype=dtype)
    return torch.empty(full, dtype=dtype, device=device)


def _lane_chunks(block, y, operands):
    """(block, y, operands) of each launch: at most ``_LANES`` lanes each,
    as views of the lane dim (a shared operand as it is)."""
    S = len(block.salts)
    if S <= _LANES:
        return [(block, y, operands)]
    out = []
    for l0 in range(0, S, _LANES):
        n = min(_LANES, S - l0)
        part = block._replace(salts=block.salts[l0:l0 + n])
        out.append((part, y.narrow(block.axis, l0, n), [
            t if t.shape[block.axis] == 1 else t.narrow(block.axis, l0, n)
            for t in operands]))
    return out


def _launch(wrapper, entry, block, y, operands, args):
    """Launch ``entry`` into ``y``, once for each chunk of lanes, counting
    each launch on ``wrapper``; ``args(y, operands)`` gives the arguments
    before the geometry."""
    from bayesian_torch_tpu_torch.ops.cuda import _build

    if not y.numel():
        return y
    lib = _build.load_library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        for part, yp, ops in _lane_chunks(block, y, operands):
            g = _geometry(part, yp, ops)
            code = getattr(lib, entry)(*args(yp, ops), ctypes.addressof(g),
                                       stream)
            _build.check(lib, code, wrapper.__name__)
            wrapper.launches += 1
    return y


def _flip_kernel(x, block, dtype, device):
    """K-H1 on a CUDA device: x * signs, or the signs (x None)."""
    dtype = x.dtype if x is not None else dtype
    if dtype not in _FLOATS:
        raise ValueError(f"sign_flip takes {sorted(map(str, _FLOATS))}, got "
                         f"{dtype}")
    bits, one = _FLOATS[dtype]
    y = _output(block, x, dtype, device if x is None else x.device)
    return _launch(sign_flip, "btt_sign_flip", block, y,
                   [] if x is None else [x],
                   lambda yp, ops: (ops[0].data_ptr() if ops else None,
                                    yp.data_ptr(), bits, one))


def _combine_kernel(mean, pert, block):
    dtype = torch.result_type(mean, pert)
    if dtype not in _COMBINE_CODES:
        raise ValueError(f"sign_combine takes "
                         f"{sorted(map(str, _COMBINE_CODES))}, got {dtype}")
    mean, pert = mean.to(dtype), pert.to(dtype)
    y = _output(block, pert, dtype, pert.device)
    return _launch(sign_combine, "btt_sign_combine", block, y, [mean, pert],
                   lambda yp, ops: (ops[0].data_ptr(), ops[1].data_ptr(),
                                    yp.data_ptr(), _COMBINE_CODES[dtype]))


def _flip(x, block):
    if _on_cpu(x):
        return sign_flip_plain(x, block)
    return _flip_kernel(x, block, None, None)


def _lane_sum(g, meta, block):
    """g summed over the lane dim where the operand of ``meta`` (its shape
    and dtype) is shared, in its dtype."""
    shape, dtype = meta
    if block.axis is not None and shape[block.axis] == 1 \
            and g.shape[block.axis] != 1:
        g = g.sum(block.axis, keepdim=True)
    return g.to(dtype)


class _SignFlip(torch.autograd.Function):
    """K-H1 forward and backward; keeps the block, never the signs."""

    @staticmethod
    def forward(ctx, x, block):
        with tracing.kernel_span(sign_flip):
            _check_operand(x, block, "x")
            ctx.block, ctx.meta = block, (tuple(x.shape), x.dtype)
            return _flip(x, block)

    @staticmethod
    def backward(ctx, g):
        # K-H1 again, as a Function: flip is linear, so the backward is
        # itself differentiable (higher derivatives)
        return _lane_sum(_SignFlip.apply(g, ctx.block), ctx.meta,
                         ctx.block), None


class _SignCombine(torch.autograd.Function):
    """K-H2 forward; backward dmean = g, dpert = K-H1 on g."""

    @staticmethod
    def forward(ctx, mean, pert, block):
        with tracing.kernel_span(sign_combine):
            _check_operand(mean, block, "mean")
            _check_operand(pert, block, "pert")
            ctx.block = block
            ctx.metas = [(tuple(t.shape), t.dtype) for t in (mean, pert)]
            if _on_cpu(mean, pert):
                return sign_combine_plain(mean, pert, block)
            return _combine_kernel(mean, pert, block)

    @staticmethod
    def backward(ctx, g):
        mean, pert = ctx.metas
        dmean = dpert = None
        if ctx.needs_input_grad[0]:
            dmean = _lane_sum(g, mean, ctx.block)
        if ctx.needs_input_grad[1]:
            dpert = _lane_sum(_SignFlip.apply(g, ctx.block), pert,
                              ctx.block)
        return dmean, dpert, None


@tracing.launch_counter
def sign_flip(x, block, dtype=None, device=None):
    """K-H1: ``x * signs`` (x laid out as ``block``, or shared across its
    lanes), differentiable in x; with ``x`` None the signs themselves in
    ``dtype`` (f32 by default) on ``device`` (the CPU by default)."""
    if x is not None:
        return _SignFlip.apply(x, block)
    with tracing.kernel_span(sign_flip):
        dtype = torch.float32 if dtype is None else dtype
        device = torch.device("cpu" if device is None else device)
        if device.type == "cpu":
            return signs_plain(block, dtype, device)
        if device.type != "cuda":
            raise ValueError(f"sign_flip: signs on {device}: the CPU or a "
                             "CUDA device")
        return _flip_kernel(None, block, dtype, device)


@tracing.launch_counter
def sign_combine(mean, pert, block):
    """K-H2: ``mean + pert * signs`` (each laid out as ``block`` or shared
    across its lanes), differentiable in both."""
    return _SignCombine.apply(mean, pert, block)


def f32(v):
    """A Python scalar rounded once to f32, as torch takes it into an f32
    op, as a Python float."""
    return float(np.float32(v))


@tracing.launch_counter
@tracing.spanned("kernel.qsign_mul")
def qsign_mul(a_q, a_scale, a_zp, block, sign_scale, sign_zp, out_scale,
              out_zp, requant=None):
    """K-H3: ``qmul(a_q, quantize_uint8(signs, sign_scale, sign_zp))`` to
    (out_scale, out_zp) as uint8, ``a_q`` uint8 at (a_scale, a_zp) laid
    out as ``block`` (or shared across its lanes). With ``requant`` (scale,
    zp): ``a_q`` is a ``QTensor`` payload at that scale and (integer) zero
    point, requantized to (a_scale, a_zp) in the same pass; returns (x_q
    laid out as the signs, product)."""
    if a_q.dtype != torch.uint8:
        raise ValueError(f"qsign_mul takes a uint8 a_q, got {a_q.dtype}")
    _check_operand(a_q, block, "a_q")
    if requant is not None and requant[1] != int(requant[1]):
        raise ValueError(f"qsign_mul: a QTensor's zero point is an int, got "
                         f"{requant[1]}")
    if _on_cpu(a_q):
        return qsign_mul_plain(a_q, a_scale, a_zp, block, sign_scale,
                               sign_zp, out_scale, out_zp, requant)
    pos, neg = sign_uint8(sign_scale, sign_zp)
    b_zp = int(sign_zp)
    # qmul's multiplier, a Python float rounded once to f32 as torch
    # takes a scalar into an f32 product
    mult = f32(a_scale * sign_scale * (1.0 / out_scale))
    y = _output(block, a_q, torch.uint8, a_q.device)
    x_q = None
    operands = [a_q]
    rq = (0, 0.0, 0.0)
    if requant is not None:
        x_q = torch.empty_like(y)
        operands.append(x_q)
        # QTensor.requantize: (q - zp) * (scale / a_scale), then + a_zp
        rq = (int(requant[1]), f32(requant[0] / a_scale), f32(a_zp))
    _launch(qsign_mul, "btt_qsign_mul", block, y, operands,
            lambda yp, ops: (ops[0].data_ptr(), yp.data_ptr(), int(a_zp),
                             pos - b_zp, neg - b_zp, mult, f32(out_zp),
                             ops[1].data_ptr() if len(ops) > 1 else None,
                             *rq))
    return y if x_q is None else (x_q, y)
