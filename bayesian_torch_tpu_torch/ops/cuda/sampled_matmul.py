"""K-B: fused sampled GEMM (counterpart of
``bayesian_torch_tpu/ops/pallas/sampled_matmul.py``).

``sampled_matmul(seed, x, mu, rho)`` computes
``x @ (mu + softplus(rho) * eps)^T`` with the CUDA kernel in
``csrc/sampled_matmul.cu``, which builds each weight tile in shared memory
so the sampled weight never reaches device memory. eps of weight (n, k) is
the counter-hash normal at flat index ``n*K + k`` under the salt of draw 0
of ``seed``: it depends on (seed, n, k) only, never on the tiling, so the
plain version is ``x @ (mu + sigma * eps_full)^T``.

A CPU tensor takes the plain version. A CUDA tensor launches the kernel or
raises; this slice has no backward kernel, so a CUDA input that needs a
gradient raises.
"""

from __future__ import annotations

import torch

from bayesian_torch_tpu_torch.ops.sampling import (draw_salt, normal_fused,
                                                   sigma_from_rho)


def matmul_sampled_weight(x, mu, sigma, eps):
    """The kernel's algebra on given noise, in f32: x @ (mu+sigma*eps)^T."""
    w = mu.float() + sigma.float() * eps
    return x.float() @ w.T


def sampled_matmul_plain(seed, x, mu, sigma, out_dtype):
    """Plain torch version of the kernel (same eps)."""
    eps = normal_fused(draw_salt(seed, 0), mu.shape, device=mu.device)
    return matmul_sampled_weight(x, mu, sigma, eps).to(out_dtype)


def sampled_matmul(seed, x, mu, rho, *, out_dtype=None):
    """out = x @ (mu + softplus(rho) * eps)^T for x (M, K), mu/rho (N, K);
    returns (M, N) in ``out_dtype`` (default: x's dtype)."""
    if out_dtype is None:
        out_dtype = x.dtype
    if x.dim() != 2 or mu.dim() != 2 or x.shape[1] != mu.shape[1] \
            or mu.shape != rho.shape:
        raise ValueError(f"need x (M, K) and mu, rho (N, K); got x "
                         f"{tuple(x.shape)}, mu {tuple(mu.shape)}, rho "
                         f"{tuple(rho.shape)}")
    sigma = sigma_from_rho(rho.float())
    devices = {t.device for t in (x, mu, rho)}
    if devices == {torch.device("cpu")}:
        return sampled_matmul_plain(seed, x, mu, sigma, out_dtype)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"x, mu and rho lie on {sorted(map(str, devices))}"
                         ": all must be on one CUDA device, or on the CPU")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, mu, rho)):
        raise NotImplementedError(
            "sampled_matmul has no backward kernel yet (ROADMAP Queue 2, "
            "the training slice); call it under torch.no_grad()")
    from bayesian_torch_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    x32 = x.detach().float().contiguous()
    mu32 = mu.detach().float().contiguous()
    sigma32 = sigma.detach().contiguous()
    M, K = x32.shape
    N = mu32.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.btt_sampled_matmul(
            x32.data_ptr(), mu32.data_ptr(), sigma32.data_ptr(),
            out.data_ptr(), M, N, K, seed & 0xFFFFFFFFFFFFFFFF, stream)
    _build.check(lib, code, "sampled_matmul")
    sampled_matmul.launches += 1
    return out.to(out_dtype)


sampled_matmul.launches = 0
