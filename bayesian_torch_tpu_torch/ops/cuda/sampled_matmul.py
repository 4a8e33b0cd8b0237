"""K-B, K-D and K-E: the fused sampled GEMM and its backward, with a lane
axis (counterpart of ``bayesian_torch_tpu/ops/pallas/sampled_matmul.py``).

``sampled_matmul(seed, x, mu, rho)`` computes
``x @ (mu + softplus(rho) * eps)^T`` with the CUDA kernel in
``csrc/sampled_matmul.cu`` (K-B), which builds each weight tile in shared
memory so the sampled weight never reaches device memory. eps of weight
(n, k) is the counter-hash normal at flat index ``n*K + k`` under the salt
of draw 0 of ``seed``: it depends on (seed, n, k) only, never on the
tiling, so the plain version is ``x @ (mu + sigma * eps_full)^T``.

``sampled_matmul_batched(seed, x, mu, rho, S)`` is the S-batched form that
the JAX vmap emission dispatches (``sampled_matmul_pallas_batched``): lane
s draws eps under ``draw_salt(seed, s, N*K)``, so its weight is draw s of
``sample_scaled_normals_batch(seed, mu, sigma, S)``, and all lanes run in
ONE launch of K-B with its lane axis. x is per lane (S, M, K) or shared by
the lanes (M, K). Lane 0 is ``sampled_matmul``, bit for bit: the single
draw is the kernel with one lane.

Every function takes an optional ``window = (lane0, lane_stride,
offset)``, spelled as in ``ops/cuda/sampled_weights.py``: lane s, weight
(n, k) of the call is then lane ``lane0 + s``, counter ``offset + n*K + k``
of a launch over ``lane_stride`` counters a lane (``(0, N*K, 0)`` is the
whole launch). So a rank that computes draws [s0, s1) of an S-draw launch
passes ``(s0, N*K, 0)`` and gets those lanes of the whole launch, and a
shard of rows [n0, n0 + N_r) of a weight of N rows passes ``(lane0, N*K,
n0*K)`` and gets those columns of the whole product (``parallel/tp.py``).
The window goes to the kernels as launch scalars; the backward draws the
same window's eps.

Both are ``torch.autograd.Function``s whose residuals are (seed, S, window,
x, mu, sigma), as the JAX VJP's, never eps: the backward regenerates the weight
in ``csrc/sampled_matmul_bwd.cu``, ``dx_s = g_s @ W_s`` (K-D) and
``dmu = sum_s g_s^T x_s``, ``dsigma = sum_s (g_s^T x_s) * eps_s`` (K-E,
the lane sums that JAX's vmap transpose takes of ``_dw_s``'s per-lane
outputs). ``drho`` chains through ``softplus`` in torch autograd, as the
JAX function chains it through XLA.

A CPU tensor takes the plain versions, forward and backward. A CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import math

import torch

from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (_check_window,
                                                              _on_cpu,
                                                              _window,
                                                              _window_kw)
from bayesian_torch_tpu_torch.ops.sampling import (draw_salt, normal_fused,
                                                   sigma_from_rho)
from bayesian_torch_tpu_torch.utils import tracing


def sampled_weight(mu, sigma, eps):
    """The sampled weight on given noise, in f32: mu + sigma * eps; eps
    (N, K), or (S, N, K) for S lanes."""
    return mu.float() + sigma.float() * eps


def matmul_sampled_weight(x, mu, sigma, eps):
    """K-B's algebra on given noise, in f32: x @ (mu + sigma*eps)^T. With
    lanes (eps (S, N, K); x (S, M, K) or shared (M, K)): (S, M, N), lane
    by lane, so lane 0 is the single draw's product exactly."""
    if eps.dim() == 2:
        return x.float() @ sampled_weight(mu, sigma, eps).T
    return torch.stack([
        matmul_sampled_weight(x[s] if x.dim() == 3 else x, mu, sigma, e)
        for s, e in enumerate(eps)])


def matmul_dx(g, mu, sigma, eps):
    """K-D's algebra on given noise, in f32: g @ (mu + sigma*eps), lane by
    lane for g (S, M, N) and eps (S, N, K)."""
    if eps.dim() == 2:
        return g.float() @ sampled_weight(mu, sigma, eps)
    return torch.stack([matmul_dx(gs, mu, sigma, e) for gs, e in zip(g, eps)])


def matmul_dw(g, x, eps):
    """K-E's algebra on given noise, in f32: (dmu, dsigma) = (g^T x,
    g^T x * eps). With lanes (g (S, M, N), eps (S, N, K); x (S, M, K) or
    shared (M, K)) the sums over the lanes, added in lane order as K-E
    adds them."""
    if g.dim() == 2:
        g, eps = g[None], eps[None]
    dmu = dsig = None
    for s in range(g.shape[0]):
        d = g[s].float().T @ (x[s] if x.dim() == 3 else x).float()
        dmu = d if dmu is None else dmu + d
        dsig = d * eps[s] if dsig is None else dsig + d * eps[s]
    return dmu, dsig


def _eps(seed, shape, device, num_samples=None, window=None):
    """eps of draw 0, or the (S, *shape) stack of draws 0..S-1, in the
    counter ``window`` (module docstring)."""
    lane0, stride, offset = _window(window, math.prod(shape))

    def lane(s):
        return normal_fused(draw_salt(seed, lane0 + s, stride), shape,
                            device=device, start=offset)

    if num_samples is None:
        return lane(0)
    return torch.stack([lane(s) for s in range(num_samples)])


def sampled_matmul_plain(seed, x, mu, sigma, out_dtype, window=None):
    """Plain torch version of K-B (same eps)."""
    eps = _eps(seed, mu.shape, x.device, window=window)
    return matmul_sampled_weight(x, mu, sigma, eps).to(out_dtype)


def sampled_matmul_batched_plain(seed, x, mu, sigma, num_samples,
                                 out_dtype=torch.float32, window=None):
    """Plain torch version of K-B with lanes: (S, M, N), lane s on the
    eps of draw s."""
    eps = _eps(seed, mu.shape, x.device, num_samples, window)
    return matmul_sampled_weight(x, mu, sigma, eps).to(out_dtype)


def sampled_matmul_dx_batched_plain(seed, g, mu, sigma, window=None):
    """Plain torch version of K-D with lanes: f32 (S, M, K)."""
    return matmul_dx(g, mu, sigma,
                     _eps(seed, mu.shape, g.device, g.shape[0], window))


def sampled_matmul_dx_plain(seed, g, mu, sigma, window=None):
    """Plain torch version of K-D: f32 (M, K), lane 0 of the above."""
    return sampled_matmul_dx_batched_plain(seed, g[None], mu, sigma,
                                           window)[0]


def sampled_matmul_dw_batched_plain(seed, g, x, window=None):
    """Plain torch version of K-E with lanes: f32 (dmu, dsigma), each
    (N, K), summed over the lanes."""
    eps = _eps(seed, (g.shape[2], x.shape[-1]), x.device, g.shape[0],
               window)
    return matmul_dw(g, x, eps)


def sampled_matmul_dw_plain(seed, g, x, window=None):
    """Plain torch version of K-E: f32 (dmu, dsigma), each (N, K)."""
    return sampled_matmul_dw_batched_plain(seed, g[None], x, window)


def _library():
    from bayesian_torch_tpu_torch.ops.cuda import _build

    return _build, _build.load_library()


def _f32(t):
    return t.detach().float().contiguous()


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _lane_stride(x32):
    """Elements between two lanes of x: M*K, or 0 for a shared (M, K)."""
    return x32.shape[1] * x32.shape[2] if x32.dim() == 3 else 0


def _forward(seed, x, mu, sigma, num_samples, counter, window=None):
    """K-B on S lanes (1 for ``num_samples=None``): f32 (S, M, N), or
    (M, N) for one draw. Counts the launch on ``counter``."""
    if _on_cpu(x, mu, sigma):
        return matmul_sampled_weight(
            x, mu, sigma, _eps(seed, mu.shape, x.device, num_samples,
                               window))
    build, lib = _library()
    x32, mu32, sigma32 = _f32(x), _f32(mu), _f32(sigma)
    S = num_samples or 1
    M, K = x32.shape[-2:]
    N = mu32.shape[0]
    out = torch.empty((S, M, N), dtype=torch.float32, device=x.device)
    code = lib.btt_sampled_matmul(
        x32.data_ptr(), _lane_stride(x32), mu32.data_ptr(),
        sigma32.data_ptr(), out.data_ptr(), S, M, N, K,
        seed & 0xFFFFFFFFFFFFFFFF, *_window(window, N * K),
        _stream(x.device))
    build.check(lib, code, counter.__name__)
    counter.launches += 1
    return out if num_samples else out[0]


def _dx(seed, g, mu, sigma, counter, window=None):
    """K-D on the lanes of g (S, M, N): f32 (S, M, K)."""
    if _on_cpu(g, mu, sigma):
        return sampled_matmul_dx_batched_plain(seed, g, mu, sigma, window)
    build, lib = _library()
    g32, mu32, sigma32 = _f32(g), _f32(mu), _f32(sigma)
    S, M, N = g32.shape
    K = mu32.shape[1]
    dx = torch.empty((S, M, K), dtype=torch.float32, device=g.device)
    code = lib.btt_sampled_matmul_dx(
        g32.data_ptr(), mu32.data_ptr(), sigma32.data_ptr(), dx.data_ptr(),
        S, M, N, K, seed & 0xFFFFFFFFFFFFFFFF, *_window(window, N * K),
        _stream(g.device))
    build.check(lib, code, counter.__name__)
    counter.launches += 1
    return dx


def _dw(seed, g, x, counter, window=None):
    """K-E on the lanes of g (S, M, N), x (S, M, K) or shared (M, K): f32
    (dmu, dsigma), each (N, K), summed over the lanes. A bf16 x (the draw
    loop's head input) is read as it is: the same values as its f32 copy,
    and the same bits out."""
    if _on_cpu(g, x):
        return sampled_matmul_dw_batched_plain(seed, g, x, window)
    build, lib = _library()
    g32 = _f32(g)
    xk = (x.detach().contiguous() if x.dtype == torch.bfloat16
          else _f32(x))
    S, M, N = g32.shape
    K = xk.shape[-1]
    dmu = torch.empty((N, K), dtype=torch.float32, device=g.device)
    dsig = torch.empty_like(dmu)
    code = lib.btt_sampled_matmul_dw(
        g32.data_ptr(), xk.data_ptr(), _lane_stride(xk),
        int(xk.dtype == torch.bfloat16), dmu.data_ptr(), dsig.data_ptr(), S,
        M, N, K, seed & 0xFFFFFFFFFFFFFFFF, *_window(window, N * K),
        _stream(g.device))
    build.check(lib, code, counter.__name__)
    counter.launches += 1
    return dmu, dsig


@tracing.launch_counter
@tracing.spanned("kernel.sampled_matmul_dx")
def sampled_matmul_dx(seed, g, mu, sigma, window=None):
    """K-D: dx = g @ (mu + sigma * eps) for g (M, N), mu and sigma
    (N, K); f32 (M, K). CPU tensors take the plain version."""
    return _dx(seed, g[None], mu, sigma, sampled_matmul_dx, window)[0]


@tracing.launch_counter
@tracing.spanned("kernel.sampled_matmul_dw")
def sampled_matmul_dw(seed, g, x, window=None):
    """K-E: (dmu, dsigma) = (g^T x, g^T x * eps) for g (M, N), x (M, K);
    f32, each (N, K). CPU tensors take the plain version."""
    return _dw(seed, g[None], x, sampled_matmul_dw, window)


@tracing.launch_counter
@tracing.spanned("kernel.sampled_matmul_dx_batched")
def sampled_matmul_dx_batched(seed, g, mu, sigma, window=None):
    """K-D with lanes: dx_s = g_s @ W_s for g (S, M, N); f32 (S, M, K).
    CPU tensors take the plain version."""
    return _dx(seed, g, mu, sigma, sampled_matmul_dx_batched, window)


@tracing.launch_counter
@tracing.spanned("kernel.sampled_matmul_dw_batched")
def sampled_matmul_dw_batched(seed, g, x, window=None):
    """K-E with lanes: (sum_s g_s^T x_s, sum_s g_s^T x_s * eps_s) for g
    (S, M, N), x (S, M, K) or shared (M, K); f32, each (N, K). CPU
    tensors take the plain version."""
    return _dw(seed, g, x, sampled_matmul_dw_batched, window)


class _SampledMatmul(torch.autograd.Function):
    """K-B forward; K-D and K-E backward, for one draw (``num_samples``
    None: x (M, K) -> (M, N)) or S lanes (x (S, M, K) or shared (M, K) ->
    (S, M, N)). Residuals (seed, S, window, x, mu, sigma), as JAX
    ``_vjp_fwd2`` (with the window); f32 out."""

    @staticmethod
    def forward(ctx, seed, num_samples, x, mu, sigma, window):
        ctx.seed, ctx.num_samples, ctx.window = seed, num_samples, window
        ctx.save_for_backward(x, mu, sigma)
        counter = sampled_matmul if num_samples is None \
            else sampled_matmul_batched
        with tracing.kernel_span(counter):
            return _forward(seed, x, mu, sigma, num_samples, counter,
                            window)

    @staticmethod
    def backward(ctx, g):
        x, mu, sigma = ctx.saved_tensors
        seed = ctx.seed
        lanes = ctx.num_samples is not None
        kw = _window_kw(ctx.window)
        dx = dmu = dsig = None
        if ctx.needs_input_grad[2]:
            if not lanes:
                dx = sampled_matmul_dx(seed, g, mu, sigma, **kw)
            else:
                dx = sampled_matmul_dx_batched(seed, g, mu, sigma, **kw)
                if x.dim() == 2:  # x shared by the lanes
                    dx = dx.sum(0)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            dmu, dsig = (sampled_matmul_dw_batched(seed, g, x, **kw) if lanes
                         else sampled_matmul_dw(seed, g, x, **kw))
            dmu, dsig = dmu.to(mu.dtype), dsig.to(sigma.dtype)
        return None, None, dx, dmu, dsig, None


@tracing.launch_counter
def sampled_matmul(seed, x, mu, rho, *, out_dtype=None, window=None):
    """out = x @ (mu + softplus(rho) * eps)^T for x (M, K), mu/rho (N, K);
    returns (M, N) in ``out_dtype`` (default: x's dtype), eps in the
    counter ``window`` (module docstring). Differentiable in x, mu and
    rho."""
    if out_dtype is None:
        out_dtype = x.dtype
    if x.dim() != 2 or mu.dim() != 2 or x.shape[1] != mu.shape[1] \
            or mu.shape != rho.shape:
        raise ValueError(f"need x (M, K) and mu, rho (N, K); got x "
                         f"{tuple(x.shape)}, mu {tuple(mu.shape)}, rho "
                         f"{tuple(rho.shape)}")
    _check_window(1, mu.numel(), window)
    sigma = sigma_from_rho(rho.float())
    return _SampledMatmul.apply(seed, None, x, mu, sigma,
                                window).to(out_dtype)


@tracing.launch_counter
def sampled_matmul_batched(seed, x, mu, rho, num_samples=None, *,
                           out_dtype=None, window=None):
    """All S lanes in one launch: lane s = x_s @ (mu + softplus(rho) *
    eps_s)^T, eps_s the noise of draw s of ``seed``, or of lane ``lane0 +
    s`` in the counter ``window`` (module docstring). ``x`` is (S, M, K),
    or (M, K) shared by ``num_samples`` lanes; mu/rho (N, K). Returns
    (S, M, N) in ``out_dtype`` (default: x's dtype). Differentiable in x,
    mu and rho (``dmu``, ``drho`` summed over the lanes)."""
    if out_dtype is None:
        out_dtype = x.dtype
    if mu.dim() != 2 or rho.dim() != 2:
        raise NotImplementedError(
            "sampled_matmul_batched: lanes over mu/rho (posterior "
            f"ensembles) are not supported, only over the MC draws; got mu "
            f"{tuple(mu.shape)}, rho {tuple(rho.shape)}")
    if x.dim() == 3 and num_samples is None:
        num_samples = x.shape[0]
    if x.dim() not in (2, 3) or num_samples is None or num_samples < 1 \
            or (x.dim() == 3 and x.shape[0] != num_samples) \
            or x.shape[-1] != mu.shape[1] or mu.shape != rho.shape:
        raise ValueError(f"need x (S, M, K), or (M, K) with num_samples, "
                         f"and mu, rho (N, K); got x {tuple(x.shape)}, "
                         f"num_samples {num_samples}, mu {tuple(mu.shape)}, "
                         f"rho {tuple(rho.shape)}")
    _check_window(num_samples, mu.numel(), window)
    sigma = sigma_from_rho(rho.float())
    return _SampledMatmul.apply(seed, int(num_samples), x, mu, sigma,
                                window).to(out_dtype)
