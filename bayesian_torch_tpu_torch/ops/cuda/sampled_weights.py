"""K-A and K-C: the weight samplers and their backward (counterpart of
``bayesian_torch_tpu/ops/pallas/sampled_weights.py``).

``sample_scaled_normals_batch(seed, mu, sigma, S)`` returns all S draws
``mu + sigma * eps(seed, s, i)`` in one launch of the CUDA kernel in
``csrc/sampled_weights.cu`` (K-A), reading mu and sigma once.
``sample_gaussian(seed, mu, rho)`` is the single draw ``mu + softplus(rho)
* eps``: K-A with S = 1 in its rho mode, which reads rho and takes
``sigma = softplus(rho)`` in the kernel, as the TPU's ``_sample_kernel``
does. eps is the counter-hash normal of ``ops/sampling.py``, so the plain
versions beside the kernels give the same values.

Both are ``torch.autograd.Function``s that save the seed, never eps: the
backward draws eps again in ``csrc/sampled_weights_bwd.cu`` (K-C), as the
JAX VJPs regenerate it. ``dmu`` is a torch sum (JAX takes it in XLA,
outside the kernel); ``dsigma`` (K-C) or ``drho`` (K-C in its rho mode,
``g * eps * sigmoid(rho)``) come from the kernel.

Every function takes an optional ``window = (lane0, lane_stride,
offset)``: lane s, element i of the launch is then lane ``lane0 + s``,
element ``offset + i`` of a launch over ``lane_stride`` elements a lane
(``(0, n, 0)`` is the whole launch). So a rank that computes draws [s0,
s1) of an S-draw launch over n elements passes ``(s0, n, 0)`` and gets
those lanes of the whole launch element for element, and a dim-0 shard r
of n_r elements passes ``offset = r * n_r`` (``parallel/mc.py``,
``parallel/tp.py``).

A CPU tensor takes the plain versions, forward and backward. A CUDA
tensor launches the kernels or raises. Both kernels' C entries choose
their launch shape from n and the card (``csrc/elementwise.cuh``).
"""

from __future__ import annotations

import math

import torch

from bayesian_torch_tpu_torch.ops.sampling import (check_counters,
                                                   draw_salt, normal_fused,
                                                   sigma_from_rho)

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_G_DTYPES = (torch.float32, torch.bfloat16)


def scale_shift(mu, sigma, eps, out_dtype):
    """The sampler's algebra on given noise: mu + sigma * eps in f32,
    cast to ``out_dtype``; eps carries the leading draw axis."""
    return (mu.float() + sigma.float() * eps).to(out_dtype)


def noise_grad(g, eps_of):
    """sum_s g[s] * eps_of(s) in f32, draw by draw (the order K-C sums
    in); ``eps_of(s)`` gives draw s's noise."""
    acc = g[0].float() * eps_of(0)
    for s in range(1, g.shape[0]):
        acc = acc + g[s].float() * eps_of(s)
    return acc


def _window(window, n):
    """(lane0, lane_stride, offset) of a launch over n elements a lane."""
    return (0, n, 0) if window is None else tuple(int(v) for v in window)


def _window_kw(window):
    """The ``window`` keyword of a call, left out for a whole launch."""
    return {} if window is None else {"window": window}


def _eps(seed, s, shape, device, window=None):
    """Lane s of a launch over ``shape``, in its window."""
    lane0, stride, offset = _window(window, math.prod(shape))
    return normal_fused(draw_salt(seed, lane0 + s, stride), shape,
                        device=device, start=offset)


def sample_scaled_normals_batch_plain(seed, mu, sigma, num_samples,
                                      out_dtype=torch.bfloat16,
                                      window=None):
    """Plain torch version of K-A: the same eps, draw by draw."""
    n = mu.numel()
    draws = [scale_shift(mu.reshape(-1), sigma.reshape(-1),
                         _eps(seed, s, (n,), mu.device, window), out_dtype)
             for s in range(num_samples)]
    return torch.stack(draws).reshape((num_samples,) + tuple(mu.shape))


def dsigma_plain(seed, g, window=None):
    """Plain torch version of K-C's dsigma mode: for g of shape
    (S, *shape), sum_s g[s] * eps(seed, s) in f32, of shape ``shape``."""
    return noise_grad(g, lambda s: _eps(seed, s, g.shape[1:], g.device,
                                        window))


def drho_from_noise(g, eps, rho):
    """K-C rho mode's algebra on given noise: g * eps * sigmoid(rho) in
    f32, for a single draw."""
    return noise_grad(g[None], lambda s: eps) * torch.sigmoid(rho.float())


def drho_plain(seed, g, rho, window=None):
    """Plain torch version of K-C's rho mode: g * eps(seed, 0) *
    sigmoid(rho) in f32, for a single draw g of rho's shape."""
    return drho_from_noise(g, _eps(seed, 0, g.shape, g.device, window), rho)


def _on_cpu(*tensors):
    """True for CPU tensors (the plain versions); raise unless all lie
    on one CUDA device otherwise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"tensors on {sorted(map(str, devices))}: all "
                         "must be on one CUDA device, or on the CPU")
    return False


def _library():
    from bayesian_torch_tpu_torch.ops.cuda import _build

    return _build, _build.load_library()


def _operands(*tensors):
    """The tensors as the kernels read them: contiguous, detached, and
    all bf16 or all f32 (anything else is cast to f32)."""
    kind = (torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in tensors)
            else torch.float32)
    return [t.detach().to(kind).contiguous() for t in tensors]


def _launch_sample(seed, mu, sigma, num_samples, out_dtype, rho_mode=False,
                   window=None):
    """K-A on CUDA tensors: (S, *mu.shape) in ``out_dtype``. With
    ``rho_mode``, ``sigma`` holds rho and the kernel takes its softplus.
    mu and sigma in bf16 are read as they are, else in f32."""
    build, lib = _library()
    mu_k, sigma_k = _operands(mu, sigma)
    n = mu_k.numel()
    lane0, stride, offset = _window(window, n)
    out = torch.empty((num_samples,) + tuple(mu.shape), dtype=out_dtype,
                      device=mu.device)
    with torch.cuda.device(mu.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.btt_sample_scaled_normals_batch(
            mu_k.data_ptr(), sigma_k.data_ptr(),
            int(mu_k.dtype == torch.bfloat16), out.data_ptr(), n,
            num_samples, seed & 0xFFFFFFFFFFFFFFFF,
            int(out_dtype == torch.bfloat16), int(rho_mode), lane0,
            stride, offset, stream)
    build.check(lib, code, "sample_scaled_normals_batch")
    sample_scaled_normals_batch.launches += 1
    return out


def _launch_noise_grad(seed, g, rho, what, window=None):
    """K-C on CUDA tensors: g (S, *shape) in f32 or bf16, rho (shape; bf16
    read as it is, else in f32) or None; returns the f32 gradient of shape
    ``shape``."""
    build, lib = _library()
    if g.dtype not in _G_DTYPES:
        g = g.float()
    g = g.contiguous()
    rho_k = None if rho is None else _operands(rho)[0]
    out = torch.empty(g.shape[1:], dtype=torch.float32, device=g.device)
    lane0, stride, offset = _window(window, out.numel())
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.btt_sampled_weights_bwd(
            g.data_ptr(), int(g.dtype == torch.bfloat16),
            None if rho_k is None else rho_k.data_ptr(),
            int(rho_k is not None and rho_k.dtype == torch.bfloat16),
            out.data_ptr(), out.numel(), g.shape[0],
            seed & 0xFFFFFFFFFFFFFFFF, lane0, stride, offset, stream)
    build.check(lib, code, what)
    return out


def dsigma(seed, g, window=None):
    """K-C, dsigma mode: sum_s g[s] * eps(seed, s) for g (S, *shape),
    f32 out. CPU tensors take ``dsigma_plain``."""
    if _on_cpu(g):
        return dsigma_plain(seed, g, window)
    out = _launch_noise_grad(seed, g, None, "dsigma", window)
    dsigma.launches += 1
    return out


def drho(seed, g, rho, window=None):
    """K-C, rho mode: g * eps(seed, 0) * sigmoid(rho) for a single draw
    g of rho's shape, f32 out. CPU tensors take ``drho_plain``."""
    if g.shape != rho.shape:
        raise ValueError(f"g {tuple(g.shape)} and rho {tuple(rho.shape)} "
                         "differ in shape")
    if _on_cpu(g, rho):
        return drho_plain(seed, g, rho, window)
    out = _launch_noise_grad(seed, g[None], rho, "drho", window)
    drho.launches += 1
    return out


dsigma.launches = 0
drho.launches = 0


class _BatchSampler(torch.autograd.Function):
    """K-A forward, K-C backward; saves (seed, window), never eps."""

    @staticmethod
    def forward(ctx, seed, mu, sigma, num_samples, out_dtype, window):
        ctx.seed, ctx.window = seed, window
        ctx.dtypes = (mu.dtype, sigma.dtype)
        if _on_cpu(mu, sigma):
            return sample_scaled_normals_batch_plain(
                seed, mu, sigma, num_samples, out_dtype, window)
        return _launch_sample(seed, mu, sigma, num_samples, out_dtype,
                              window=window)

    @staticmethod
    def backward(ctx, g):
        dmu = dsig = None
        if ctx.needs_input_grad[1]:
            dmu = g.float().sum(0).to(ctx.dtypes[0])
        if ctx.needs_input_grad[2]:
            dsig = dsigma(ctx.seed, g, **_window_kw(ctx.window)).to(
                ctx.dtypes[1])
        return None, dmu, dsig, None, None, None


class _GaussianSampler(torch.autograd.Function):
    """K-A with S = 1 in its rho mode forward (the plain version takes
    sigma = softplus(rho) in torch); dmu = g and K-C's rho mode backward.
    Saves the seed and rho, never eps."""

    @staticmethod
    def forward(ctx, seed, mu, rho, out_dtype, window):
        ctx.seed, ctx.window = seed, window
        ctx.mu_dtype = mu.dtype
        ctx.save_for_backward(rho)
        if _on_cpu(mu, rho):
            w = sample_scaled_normals_batch_plain(
                seed, mu, sigma_from_rho(rho.float()), 1, out_dtype, window)
        else:
            w = _launch_sample(seed, mu, rho, 1, out_dtype, rho_mode=True,
                               window=window)
        return w[0]

    @staticmethod
    def backward(ctx, g):
        (rho,) = ctx.saved_tensors
        dmu = d_rho = None
        if ctx.needs_input_grad[1]:
            dmu = g.to(ctx.mu_dtype)
        if ctx.needs_input_grad[2]:
            d_rho = drho(ctx.seed, g, rho, **_window_kw(ctx.window)).to(
                rho.dtype)
        return None, dmu, d_rho, None, None


def _check_sampler_args(mu, other, name, out_dtype):
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}, "
                         f"got {out_dtype}")
    if mu.shape != other.shape:
        raise ValueError(f"mu {tuple(mu.shape)} and {name} "
                         f"{tuple(other.shape)} differ in shape")


def _check_window(num_samples, n, window):
    lane0, stride, offset = _window(window, n)
    if lane0 < 0 or offset < 0 or offset + n > stride:
        raise ValueError(f"window {(lane0, stride, offset)} does not hold "
                         f"lanes of {n} elements")
    check_counters(lane0 + num_samples, stride)


def sample_scaled_normals_batch(seed, mu, sigma, num_samples,
                                out_dtype=torch.bfloat16, window=None):
    """All ``num_samples`` draws of mu + sigma * eps: (S, *mu.shape), or
    the lanes of a counter ``window`` (module docstring). Differentiable
    in mu and sigma (backward: K-C, dsigma mode, on the same window)."""
    _check_sampler_args(mu, sigma, "sigma", out_dtype)
    num_samples = int(num_samples)
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    _check_window(num_samples, mu.numel(), window)
    return _BatchSampler.apply(seed, mu, sigma, num_samples, out_dtype,
                               window)


sample_scaled_normals_batch.launches = 0  # K-A launches, from any caller


def sample_gaussian(seed, mu, rho, out_dtype=torch.bfloat16, window=None):
    """One draw of mu + softplus(rho) * eps, in ``out_dtype``; the
    counterpart of ``sample_gaussian_pallas``. Differentiable in mu and
    rho (backward: dmu = g, drho from K-C's rho mode)."""
    _check_sampler_args(mu, rho, "rho", out_dtype)
    _check_window(1, mu.numel(), window)
    return _GaussianSampler.apply(seed, mu, rho, out_dtype, window)


def sample_gaussian_batch(seed, mu, rho, num_samples,
                          out_dtype=torch.bfloat16, window=None):
    """sigma = softplus(rho) in torch (once), draws by the batch sampler;
    the counterpart of ``sample_gaussian_pallas_batch``."""
    return sample_scaled_normals_batch(seed, mu, sigma_from_rho(rho),
                                       num_samples, out_dtype, window)
