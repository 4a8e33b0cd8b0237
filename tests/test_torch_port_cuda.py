"""Card-only checks of the port's CUDA kernels against their plain torch
versions, at small and ragged shapes (the full shapes are in
chip_smoke.py). They skip without a CUDA device. On a machine with one,
and without JAX, run them with

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX). This file imports
torch and the port only.
"""

import pytest
import torch

from bayesian_torch_tpu_torch.ops.cuda.sampled_matmul import (
    sampled_matmul,
    sampled_matmul_plain,
)
from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
    sample_scaled_normals_batch,
    sample_scaled_normals_batch_plain,
)
from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _posterior(shape, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    mu = (0.3 * torch.randn(shape, generator=g)).to(device)
    rho = (torch.randn(shape, generator=g) - 3.0).to(device)
    return mu, sigma_from_rho(rho), rho


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 4096 + 5, 300_000])
@pytest.mark.parametrize("num_samples", [1, 3])
def test_batch_sampler_matches_plain_f32(cuda, n, num_samples):
    mu, sigma, _ = _posterior((n,), cuda)
    seed = 0x1234_5678_9ABC_DEF0
    got = sample_scaled_normals_batch(seed, mu, sigma, num_samples,
                                      torch.float32)
    want = sample_scaled_normals_batch_plain(seed, mu, sigma, num_samples,
                                             torch.float32)
    torch.cuda.synchronize()
    assert got.shape == (num_samples, n)
    # same eps up to the last ulp of the log/cos of two CUDA libraries
    assert (got - want).abs().max().item() <= 1e-5


def test_batch_sampler_unaligned_view_bf16(cuda):
    """A view at an odd offset takes the scalar path; bf16 out within one
    bf16 ulp of the plain version (rounding of the same f32 value)."""
    mu, sigma, _ = _posterior((4097,), cuda)
    mu, sigma = mu[1:], sigma[1:]
    got = sample_scaled_normals_batch(7, mu, sigma, 2).float()
    want = sample_scaled_normals_batch_plain(7, mu, sigma, 2).float()
    ulp = torch.finfo(torch.bfloat16).eps * want.abs().clamp_min(1e-30)
    assert bool(((got - want).abs() <= ulp).all())


def test_batch_sampler_refuses_grad(cuda):
    mu, sigma, _ = _posterior((16,), cuda)
    mu.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        sample_scaled_normals_batch(0, mu, sigma, 2)
    with torch.no_grad():
        sample_scaled_normals_batch(0, mu, sigma, 2)


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (5, 33, 17), (128, 1000, 2048),
                                   (130, 64, 40)])
def test_sampled_matmul_matches_plain(cuda, m, n, k):
    mu, sigma, rho = _posterior((n, k), cuda, seed=1)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(2)
                    ).to(cuda)
    seed = 99
    got = sampled_matmul(seed, x, mu, rho, out_dtype=torch.float32)
    want = sampled_matmul_plain(seed, x, mu, sigma, torch.float32)
    torch.cuda.synchronize()
    # f32 sums of k products in another order than cuBLAS's
    tol = 1e-4 * max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= tol
