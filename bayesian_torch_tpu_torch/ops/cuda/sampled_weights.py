"""K-A: batch weight sampler (counterpart of
``bayesian_torch_tpu/ops/pallas/sampled_weights.py``).

``sample_scaled_normals_batch(seed, mu, sigma, S)`` returns all S draws
``mu + sigma * eps(seed, s, i)`` in one launch of the CUDA kernel in
``csrc/sampled_weights.cu``, reading mu and sigma once. eps is the
counter-hash normal of ``ops/sampling.py``, so the plain version beside
the kernel gives the same values.

A CPU tensor takes the plain version, which autograd differentiates. A
CUDA tensor launches the kernel or raises; this slice has no backward
kernel, so a CUDA input that needs a gradient raises.
"""

from __future__ import annotations

import torch

from bayesian_torch_tpu_torch.ops.sampling import draw_salt, normal_fused

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def scale_shift(mu, sigma, eps, out_dtype):
    """The sampler's algebra on given noise: mu + sigma * eps in f32,
    cast to ``out_dtype``; eps carries the leading draw axis."""
    return (mu.float() + sigma.float() * eps).to(out_dtype)


def sample_scaled_normals_batch_plain(seed, mu, sigma, num_samples,
                                      out_dtype=torch.bfloat16):
    """Plain torch version of the kernel: the same eps, draw by draw."""
    n = mu.numel()
    draws = [scale_shift(mu.reshape(-1), sigma.reshape(-1),
                         normal_fused(draw_salt(seed, s), (n,),
                                      device=mu.device), out_dtype)
             for s in range(num_samples)]
    return torch.stack(draws).reshape((num_samples,) + tuple(mu.shape))


def sample_scaled_normals_batch(seed, mu, sigma, num_samples,
                                out_dtype=torch.bfloat16):
    """All ``num_samples`` draws of mu + sigma * eps: (S, *mu.shape)."""
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, "
                         f"got {out_dtype}")
    if mu.shape != sigma.shape:
        raise ValueError(f"mu {tuple(mu.shape)} and sigma "
                         f"{tuple(sigma.shape)} differ in shape")
    num_samples = int(num_samples)
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if mu.device.type == "cpu" and sigma.device.type == "cpu":
        return sample_scaled_normals_batch_plain(seed, mu, sigma,
                                                 num_samples, out_dtype)
    if mu.device.type != "cuda" or sigma.device != mu.device:
        raise ValueError(f"mu on {mu.device} and sigma on {sigma.device}: "
                         "both must be on one CUDA device, or on the CPU")
    if torch.is_grad_enabled() and (mu.requires_grad or sigma.requires_grad):
        raise NotImplementedError(
            "sample_scaled_normals_batch has no backward kernel yet "
            "(ROADMAP Queue 2, the training slice); call it under "
            "torch.no_grad()")
    from bayesian_torch_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    mu32 = mu.detach().float().contiguous()
    sigma32 = sigma.detach().float().contiguous()
    out = torch.empty((num_samples,) + tuple(mu.shape), dtype=out_dtype,
                      device=mu.device)
    with torch.cuda.device(mu.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.btt_sample_scaled_normals_batch(
            mu32.data_ptr(), sigma32.data_ptr(), out.data_ptr(),
            mu32.numel(), num_samples, seed & 0xFFFFFFFFFFFFFFFF,
            int(out_dtype == torch.bfloat16), stream)
    _build.check(lib, code, "sample_scaled_normals_batch")
    sample_scaled_normals_batch.launches += 1
    return out


sample_scaled_normals_batch.launches = 0


def sample_gaussian_batch(seed, mu, rho, num_samples,
                          out_dtype=torch.bfloat16):
    """sigma = softplus(rho) in torch (once), draws by the batch sampler;
    the counterpart of ``sample_gaussian_pallas_batch``."""
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    return sample_scaled_normals_batch(seed, mu, sigma_from_rho(rho),
                                       num_samples, out_dtype)
