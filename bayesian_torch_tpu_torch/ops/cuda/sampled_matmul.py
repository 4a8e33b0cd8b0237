"""K-B, K-D and K-E: the fused sampled GEMM and its backward (counterpart
of ``bayesian_torch_tpu/ops/pallas/sampled_matmul.py``).

``sampled_matmul(seed, x, mu, rho)`` computes
``x @ (mu + softplus(rho) * eps)^T`` with the CUDA kernel in
``csrc/sampled_matmul.cu`` (K-B), which builds each weight tile in shared
memory so the sampled weight never reaches device memory. eps of weight
(n, k) is the counter-hash normal at flat index ``n*K + k`` under the salt
of draw 0 of ``seed``: it depends on (seed, n, k) only, never on the
tiling, so the plain version is ``x @ (mu + sigma * eps_full)^T``.

It is a ``torch.autograd.Function`` whose residuals are (seed, x, mu,
sigma), as the JAX VJP's: the backward regenerates the weight in
``csrc/sampled_matmul_bwd.cu``, ``dx = g @ W`` (K-D) and ``dmu = g^T x``,
``dsigma = dmu * eps`` (K-E). ``drho`` chains through ``softplus`` in
torch autograd, as the JAX function chains it through XLA.

A CPU tensor takes the plain versions, forward and backward. A CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import _on_cpu
from bayesian_torch_tpu_torch.ops.sampling import (draw_salt, normal_fused,
                                                   sigma_from_rho)


def sampled_weight(mu, sigma, eps):
    """The sampled weight on given noise, in f32: mu + sigma * eps."""
    return mu.float() + sigma.float() * eps


def matmul_sampled_weight(x, mu, sigma, eps):
    """K-B's algebra on given noise, in f32: x @ (mu + sigma*eps)^T."""
    return x.float() @ sampled_weight(mu, sigma, eps).T


def matmul_dx(g, mu, sigma, eps):
    """K-D's algebra on given noise, in f32: g @ (mu + sigma*eps)."""
    return g.float() @ sampled_weight(mu, sigma, eps)


def matmul_dw(g, x, eps):
    """K-E's algebra on given noise, in f32: (dmu, dsigma) = (g^T x,
    g^T x * eps)."""
    dmu = g.float().T @ x.float()
    return dmu, dmu * eps


def _eps(seed, mu):
    return normal_fused(draw_salt(seed, 0), mu.shape, device=mu.device)


def sampled_matmul_plain(seed, x, mu, sigma, out_dtype):
    """Plain torch version of K-B (same eps)."""
    return matmul_sampled_weight(x, mu, sigma, _eps(seed, mu)).to(out_dtype)


def sampled_matmul_dx_plain(seed, g, mu, sigma):
    """Plain torch version of K-D: f32 (M, K)."""
    return matmul_dx(g, mu, sigma, _eps(seed, mu))


def sampled_matmul_dw_plain(seed, g, x):
    """Plain torch version of K-E: f32 (dmu, dsigma), each (N, K)."""
    eps = normal_fused(draw_salt(seed, 0), (g.shape[1], x.shape[1]),
                       device=x.device)
    return matmul_dw(g, x, eps)


def _library():
    from bayesian_torch_tpu_torch.ops.cuda import _build

    return _build, _build.load_library()


def _f32(t):
    return t.detach().float().contiguous()


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _launch_forward(seed, x, mu, sigma):
    build, lib = _library()
    x32, mu32, sigma32 = _f32(x), _f32(mu), _f32(sigma)
    M, K = x32.shape
    N = mu32.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    code = lib.btt_sampled_matmul(
        x32.data_ptr(), mu32.data_ptr(), sigma32.data_ptr(), out.data_ptr(),
        M, N, K, seed & 0xFFFFFFFFFFFFFFFF, _stream(x.device))
    build.check(lib, code, "sampled_matmul")
    sampled_matmul.launches += 1
    return out


def sampled_matmul_dx(seed, g, mu, sigma):
    """K-D: dx = g @ (mu + sigma * eps) for g (M, N), mu and sigma
    (N, K); f32 (M, K). CPU tensors take the plain version."""
    if _on_cpu(g, mu, sigma):
        return sampled_matmul_dx_plain(seed, g, mu, sigma)
    build, lib = _library()
    g32, mu32, sigma32 = _f32(g), _f32(mu), _f32(sigma)
    M, N = g32.shape
    K = mu32.shape[1]
    dx = torch.empty((M, K), dtype=torch.float32, device=g.device)
    code = lib.btt_sampled_matmul_dx(
        g32.data_ptr(), mu32.data_ptr(), sigma32.data_ptr(), dx.data_ptr(),
        M, N, K, seed & 0xFFFFFFFFFFFFFFFF, _stream(g.device))
    build.check(lib, code, "sampled_matmul_dx")
    sampled_matmul_dx.launches += 1
    return dx


def sampled_matmul_dw(seed, g, x):
    """K-E: (dmu, dsigma) = (g^T x, g^T x * eps) for g (M, N), x (M, K);
    f32, each (N, K). CPU tensors take the plain version."""
    if _on_cpu(g, x):
        return sampled_matmul_dw_plain(seed, g, x)
    build, lib = _library()
    g32, x32 = _f32(g), _f32(x)
    M, N = g32.shape
    K = x32.shape[1]
    dmu = torch.empty((N, K), dtype=torch.float32, device=g.device)
    dsig = torch.empty_like(dmu)
    code = lib.btt_sampled_matmul_dw(
        g32.data_ptr(), x32.data_ptr(), dmu.data_ptr(), dsig.data_ptr(),
        M, N, K, seed & 0xFFFFFFFFFFFFFFFF, _stream(g.device))
    build.check(lib, code, "sampled_matmul_dw")
    sampled_matmul_dw.launches += 1
    return dmu, dsig


sampled_matmul_dx.launches = 0
sampled_matmul_dw.launches = 0


class _SampledMatmul(torch.autograd.Function):
    """K-B forward; K-D and K-E backward. Residuals (seed, x, mu,
    sigma), as JAX ``_vjp_fwd2``; f32 out."""

    @staticmethod
    def forward(ctx, seed, x, mu, sigma):
        ctx.seed = seed
        ctx.save_for_backward(x, mu, sigma)
        if _on_cpu(x, mu, sigma):
            return matmul_sampled_weight(x, mu, sigma, _eps(seed, mu))
        return _launch_forward(seed, x, mu, sigma)

    @staticmethod
    def backward(ctx, g):
        x, mu, sigma = ctx.saved_tensors
        dx = dmu = dsig = None
        if ctx.needs_input_grad[1]:
            dx = sampled_matmul_dx(ctx.seed, g, mu, sigma).to(x.dtype)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dmu, dsig = sampled_matmul_dw(ctx.seed, g, x)
            dmu, dsig = dmu.to(mu.dtype), dsig.to(sigma.dtype)
        return None, dx, dmu, dsig


def sampled_matmul(seed, x, mu, rho, *, out_dtype=None):
    """out = x @ (mu + softplus(rho) * eps)^T for x (M, K), mu/rho (N, K);
    returns (M, N) in ``out_dtype`` (default: x's dtype). Differentiable
    in x, mu and rho."""
    if out_dtype is None:
        out_dtype = x.dtype
    if x.dim() != 2 or mu.dim() != 2 or x.shape[1] != mu.shape[1] \
            or mu.shape != rho.shape:
        raise ValueError(f"need x (M, K) and mu, rho (N, K); got x "
                         f"{tuple(x.shape)}, mu {tuple(mu.shape)}, rho "
                         f"{tuple(rho.shape)}")
    sigma = sigma_from_rho(rho.float())
    return _SampledMatmul.apply(seed, x, mu, sigma).to(out_dtype)


sampled_matmul.launches = 0
