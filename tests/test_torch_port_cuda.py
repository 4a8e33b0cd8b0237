"""Card-only checks of the port's CUDA kernels against their plain torch
versions, at small and ragged shapes (the full shapes are in
chip_smoke.py): K-A and K-B forward, K-C (both modes; K-A and K-C also
at ragged sizes, at odd offsets and S in {1, 2, 4, 10}, on either side of
their launch shapes' edge, and dsigma of ones against the sum of K-A's
draws), K-D and K-E backward, K-B, K-D and K-E with their lane axis, K-B,
K-D and K-E (its split-TF32 products and lane sums) across the edges of
their tiles, K-A's rho mode (the single draw's softplus in the kernel),
autograd through the public ops, K-F (the fused int8 GEMM + requantize)
with the quantized convs built on it (and at the CIFAR ResNet's and the
SCNN's GEMM shapes), K-A and K-C at the CIFAR ResNet's layer sizes, K-G
(the per-draw GEMM behind the pointwise emission) in bf16, f32 and int8,
and K-A and K-C under a counter window (a rank's lanes, a tensor-parallel
shard's rows) against the whole launch. They skip without a
CUDA device. On a machine with one, and without JAX, run them with

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest imports JAX). This file imports
torch and the port only.
"""

import copy

import pytest
import torch

from bayesian_torch_tpu_torch.ops import conv as conv_ops
from bayesian_torch_tpu_torch.ops import int8 as q
from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg
from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf
from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
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


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _scale(want):
    return max(want.abs().max().item(), 1.0)


def test_batch_sampler_grad_matches_plain(cuda):
    """Autograd through K-A (forward) and K-C (dsigma) equals autograd
    through the plain sampler, bf16 draws."""
    mu, sigma, _ = _posterior((4099,), cuda)
    mu.requires_grad_(True)
    sigma.requires_grad_(True)
    g = torch.randn((3, 4099), device=cuda).bfloat16()
    launches = (ka.sample_scaled_normals_batch.launches, ka.dsigma.launches)
    w = sample_scaled_normals_batch(5, mu, sigma, 3)
    got = torch.autograd.grad(w, (mu, sigma), g)
    want = torch.autograd.grad(
        sample_scaled_normals_batch_plain(5, mu, sigma, 3), (mu, sigma), g)
    torch.cuda.synchronize()
    assert (ka.sample_scaled_normals_batch.launches, ka.dsigma.launches) \
        == (launches[0] + 1, launches[1] + 1)
    for a, b in zip(got, want):
        assert _max_err(a, b) <= 1e-5 * _scale(b)


@pytest.mark.parametrize("n", [1, 3, 4, 1023, 4096 + 5, 300_001])
@pytest.mark.parametrize("num_samples", [1, 4])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_dsigma_kernel_matches_plain(cuda, n, num_samples, g_dtype):
    g = torch.randn((num_samples, n), generator=torch.Generator()
                    .manual_seed(n)).to(cuda, g_dtype)
    seed = 0xFEED_0000_1234_5678
    got = ka.dsigma(seed, g)
    want = ka.dsigma_plain(seed, g)
    torch.cuda.synchronize()
    assert got.shape == (n,) and got.dtype == torch.float32
    # same eps up to the last ulp of log/cos, same f32 order of the sum
    assert _max_err(got, want) <= 1e-5 * _scale(want)


@pytest.mark.parametrize("n", [1, 5, 1024, 300_001])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_drho_kernel_matches_plain(cuda, n, g_dtype):
    _, _, rho = _posterior((n,), cuda, seed=3)
    g = torch.randn(n, generator=torch.Generator().manual_seed(4)).to(
        cuda, g_dtype)
    got = ka.drho(17, g, rho)
    want = ka.drho_plain(17, g, rho)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= 1e-5 * _scale(want)


def test_dsigma_kernel_unaligned_view(cuda):
    """A contiguous view at an odd offset takes the scalar path."""
    g = torch.randn(2 * 4096 + 1, device=cuda)[1:].view(2, 4096)
    got = ka.dsigma(9, g)
    want = ka.dsigma_plain(9, g)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= 1e-5 * _scale(want)


# the samplers' edges: sizes around the narrow and wide launch shapes (the
# stem's 9,408 weights, the head's 2,049,000) and past 2^20
_EDGE_N = [1, 3, 1000, 1023, 9408, 2_049_000, 2**20 + 5]


def _vector(n, offset, seed, dtype=torch.float32, scale=1.0, shift=0.0):
    """n values from a seed, as a contiguous view at ``offset`` elements
    (an odd offset misaligns the kernel's vector loads)."""
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(n + offset, generator=gen) * scale + shift
    return v.to("cuda", dtype)[offset:]


def _rel(got, want):
    return _max_err(got, want) / max(want.abs().max().item(), 1e-30)


@pytest.mark.parametrize("n", _EDGE_N)
@pytest.mark.parametrize("num_samples", [1, 2, 4, 10])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_dsigma_kernel_edges(cuda, n, num_samples, g_dtype, offset):
    g = _vector(num_samples * n, offset, n, g_dtype).view(num_samples, n)
    seed = 0xFEED_0000_0000_0001 + n
    got = ka.dsigma(seed, g)
    assert torch.equal(got, ka.dsigma(seed, g))
    # same eps up to the last ulp of log/cos, same f32 order of the sum
    assert _rel(got, ka.dsigma_plain(seed, g)) <= 1e-5


@pytest.mark.parametrize("n", _EDGE_N)
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rho_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_drho_kernel_edges(cuda, n, g_dtype, rho_dtype, offset):
    """rho in bf16 (the draw loop's compute dtype) is read as it is."""
    g = _vector(n, offset, n, g_dtype)
    rho = _vector(n, offset, n + 1, rho_dtype, shift=-3.0)
    got = ka.drho(n, g, rho)
    assert torch.equal(got, ka.drho(n, g, rho))
    assert _rel(got, ka.drho_plain(n, g, rho)) <= 1e-5


@pytest.mark.parametrize("n", _EDGE_N)
@pytest.mark.parametrize("num_samples", [1, 2, 4, 10])
def test_dsigma_of_ones_is_the_sum_of_the_draws(cuda, n, num_samples):
    """Forward and backward draw one stream: K-C's dsigma of ones equals
    the f32 sum, in draw order, of K-A's draws at mu = 0, sigma = 1 (its
    eps), bit for bit."""
    seed = 2**45 + n
    draws = sample_scaled_normals_batch(
        seed, torch.zeros(n, device=cuda), torch.ones(n, device=cuda),
        num_samples, torch.float32)
    total = draws[0]
    for s in range(1, num_samples):
        total = total + draws[s]
    ones = torch.ones((num_samples, n), device=cuda)
    assert torch.equal(ka.dsigma(seed, ones), total)


def _sampler_gate(got, want):
    """f32 within 1e-5 of the plain version; bf16 within one bf16 ulp
    (rounding of f32 values that may differ in their last ulp)."""
    assert got.dtype == want.dtype
    if got.dtype == torch.float32:
        assert _max_err(got, want) <= 1e-5 * max(want.abs().max().item(), 1)
    else:
        ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
        assert bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.parametrize("n", _EDGE_N)
@pytest.mark.parametrize("num_samples", [1, 2, 4, 10])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_batch_sampler_edges(cuda, n, num_samples, out_dtype, in_dtype,
                             offset):
    mu = _vector(n, offset, n, in_dtype, scale=0.3)
    sigma = sigma_from_rho(_vector(n, offset, n + 1, shift=-3.0)).to(
        in_dtype)
    seed = 0x1234_0000_0000_0000 + n
    got = sample_scaled_normals_batch(seed, mu, sigma, num_samples,
                                      out_dtype)
    assert got.shape == (num_samples, n)
    assert torch.equal(got, sample_scaled_normals_batch(
        seed, mu, sigma, num_samples, out_dtype))
    _sampler_gate(got, sample_scaled_normals_batch_plain(
        seed, mu, sigma, num_samples, out_dtype))


@pytest.mark.parametrize("n", _EDGE_N)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_single_draw_edges(cuda, n, out_dtype, in_dtype, offset):
    """K-A's rho mode (softplus in the kernel) at the edges, rho across
    torch's softplus threshold of 20; bf16 mu and rho (the draw loop's
    compute dtype) are read as they are."""
    mu = _vector(n, offset, n, in_dtype, scale=0.3)
    rho = _vector(n, offset, n + 1, in_dtype, scale=8.0, shift=-3.0)
    got = ka.sample_gaussian(n, mu, rho, out_dtype)
    assert torch.equal(got, ka.sample_gaussian(n, mu, rho, out_dtype))
    _sampler_gate(got, sample_scaled_normals_batch_plain(
        n, mu, sigma_from_rho(rho.float()), 1, out_dtype)[0])


def _after_nan(numel, fn):
    """fn() right after a block of ``numel`` f32 NaN is freed, so that the
    caching allocator hands that memory to fn's output: an element the
    kernel leaves unwritten reads NaN."""
    torch.full((numel,), float("nan"), device="cuda")
    return fn()


@pytest.mark.parametrize("delta", [-1, 0, 5])
def test_sampler_kernels_write_every_element(cuda, delta):
    """K-A and K-C choose their launch shape in C from n and the card's
    SM count: one element a thread below four waves of 1,024 elements,
    four from there. On either side of that edge every output element is
    written and equals the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = 4 * sms * 1024 + delta
    mu, sigma, rho = _posterior((n,), cuda, seed=delta + 1)
    gen = torch.Generator().manual_seed(delta + 2)
    g = torch.randn((4, n), generator=gen).to(cuda)
    seed = 0xACE0_0000_0000_0000 + n
    f32 = torch.float32
    for s in (1, 4):
        got = _after_nan(s * n, lambda: sample_scaled_normals_batch(
            seed, mu, sigma, s, f32))
        _sampler_gate(got, sample_scaled_normals_batch_plain(
            seed, mu, sigma, s, f32))
    got = _after_nan(n, lambda: ka.sample_gaussian(seed, mu, rho, f32))
    _sampler_gate(got, sample_scaled_normals_batch_plain(
        seed, mu, sigma_from_rho(rho), 1, f32)[0])
    got = _after_nan(n, lambda: ka.dsigma(seed, g))
    assert _rel(got, ka.dsigma_plain(seed, g)) <= 1e-5
    got = _after_nan(n, lambda: ka.drho(seed, g[0], rho))
    assert _rel(got, ka.drho_plain(seed, g[0], rho)) <= 1e-5


def test_gaussian_sampler_grad_matches_plain(cuda):
    mu, _, rho = _posterior((33, 7, 3, 3), cuda, seed=5)
    mu.requires_grad_(True)
    rho.requires_grad_(True)
    w = ka.sample_gaussian(21, mu, rho, torch.bfloat16)
    g = torch.randn_like(w)
    got = torch.autograd.grad(w, (mu, rho), g)
    plain = sample_scaled_normals_batch_plain(
        21, mu, sigma_from_rho(rho), 1, torch.bfloat16)[0]
    ulp = torch.finfo(torch.bfloat16).eps * plain.detach().float().abs()
    assert bool(((w - plain).float().abs() <= ulp).all())
    want = torch.autograd.grad(plain, (mu, rho), g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _max_err(a, b) <= 1e-5 * _scale(b)


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


# K-E's tile is 128 (n) x 128 (k) over chunks of 32 rows of m: M at one
# row, under and over a chunk and 128, N and K one either side of the tile
@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (5, 33, 17), (128, 1000, 2048),
                                   (130, 64, 40), (17, 65, 129),
                                   (7, 127, 127), (1, 128, 128),
                                   (257, 129, 129), (130, 1, 255),
                                   (33, 129, 257)])
def test_sampled_matmul_backward_kernels_match_plain(cuda, m, n, k):
    mu, sigma, _ = _posterior((n, k), cuda, seed=6)
    gen = torch.Generator().manual_seed(7)
    g = torch.randn((m, n), generator=gen).to(cuda)
    x = torch.randn((m, k), generator=gen).to(cuda)
    seed = 31337
    dx = kb.sampled_matmul_dx(seed, g, mu, sigma)
    dx_want = kb.sampled_matmul_dx_plain(seed, g, mu, sigma)
    dmu, dsig = kb.sampled_matmul_dw(seed, g, x)
    dmu_want, dsig_want = kb.sampled_matmul_dw_plain(seed, g, x)
    torch.cuda.synchronize()
    # f32 sums of n (dx) or m (dw) products in another order than cuBLAS's
    for got, want in ((dx, dx_want), (dmu, dmu_want), (dsig, dsig_want)):
        assert got.shape == want.shape
        assert _max_err(got, want) <= 1e-4 * _scale(want)
    # no atomics, no order that depends on scheduling
    for a, b in zip((dmu, dsig), kb.sampled_matmul_dw(seed, g, x)):
        assert torch.equal(a, b)


def test_sampled_matmul_grad_matches_plain(cuda):
    mu, _, rho = _posterior((70, 90), cuda, seed=8)
    mu.requires_grad_(True)
    rho.requires_grad_(True)
    x = torch.randn((33, 90), device=cuda, requires_grad=True)
    g = torch.randn((33, 70), device=cuda)
    counts = (kb.sampled_matmul.launches, kb.sampled_matmul_dx.launches,
              kb.sampled_matmul_dw.launches)
    got = torch.autograd.grad(sampled_matmul(3, x, mu, rho), (x, mu, rho), g)
    assert (kb.sampled_matmul.launches, kb.sampled_matmul_dx.launches,
            kb.sampled_matmul_dw.launches) == tuple(c + 1 for c in counts)
    want = torch.autograd.grad(
        sampled_matmul_plain(3, x, mu, sigma_from_rho(rho), torch.float32),
        (x, mu, rho), g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _max_err(a, b) <= 1e-4 * _scale(b)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 10])
@pytest.mark.parametrize("m,n,k", [(37, 50, 70), (130, 33, 129),
                                   (7, 127, 127), (257, 129, 128)])
@pytest.mark.parametrize("shared", [False, True])
def test_lane_kernels_match_plain(cuda, s, m, n, k, shared):
    """K-B, K-D and K-E with lanes against their plain versions; lane 0
    equals the single-draw kernels bit for bit."""
    mu, sigma, rho = _posterior((n, k), cuda, seed=9)
    gen = torch.Generator().manual_seed(10)
    x = torch.randn((s, m, k), generator=gen).to(cuda)
    g = torch.randn((s, m, n), generator=gen).to(cuda)
    xl = x[0] if shared else x
    seed = 0xABCD_0000_0000_0042
    before = (kb.sampled_matmul_batched.launches,
              kb.sampled_matmul_dx_batched.launches,
              kb.sampled_matmul_dw_batched.launches)
    out = kb.sampled_matmul_batched(seed, xl, mu, rho, s,
                                    out_dtype=torch.float32)
    dx = kb.sampled_matmul_dx_batched(seed, g, mu, sigma)
    dmu, dsig = kb.sampled_matmul_dw_batched(seed, g, xl)
    assert (kb.sampled_matmul_batched.launches,
            kb.sampled_matmul_dx_batched.launches,
            kb.sampled_matmul_dw_batched.launches) == tuple(
                c + 1 for c in before)
    wants = (kb.sampled_matmul_batched_plain(seed, xl, mu, sigma, s),
             kb.sampled_matmul_dx_batched_plain(seed, g, mu, sigma),
             *kb.sampled_matmul_dw_batched_plain(seed, g, xl))
    torch.cuda.synchronize()
    # f32 sums of k (out), n (dx) or s*m (dw) products in another order
    for got, want in zip((out, dx, dmu, dsig), wants):
        assert got.shape == want.shape
        assert _max_err(got, want) <= 1e-4 * _scale(want)
    assert torch.equal(out[0], sampled_matmul(seed, x[0], mu, rho,
                                              out_dtype=torch.float32))
    assert torch.equal(dx[0], kb.sampled_matmul_dx(seed, g[0], mu, sigma))
    one = kb.sampled_matmul_dw_batched(seed, g[:1], x[0])
    for a, b in zip(one, kb.sampled_matmul_dw(seed, g[0], x[0])):
        assert torch.equal(a, b)


def test_lane_kernels_unaligned_view(cuda):
    """Contiguous views at an odd offset: the kernels load element-wise
    (K-E also with one lane, its kernel without lane sums)."""
    mu, sigma, rho = _posterior((33, 65), cuda, seed=11)
    x = torch.randn(3 * 17 * 65 + 1, device=cuda)[1:].view(3, 17, 65)
    g = torch.randn(3 * 17 * 33 + 1, device=cuda)[1:].view(3, 17, 33)
    got = (kb.sampled_matmul_batched(7, x, mu, rho),
           kb.sampled_matmul_dx_batched(7, g, mu, sigma),
           *kb.sampled_matmul_dw_batched(7, g, x),
           *kb.sampled_matmul_dw(7, g[0], x[0]))
    wants = (kb.sampled_matmul_batched_plain(7, x, mu, sigma, 3),
             kb.sampled_matmul_dx_batched_plain(7, g, mu, sigma),
             *kb.sampled_matmul_dw_batched_plain(7, g, x),
             *kb.sampled_matmul_dw_plain(7, g[0], x[0]))
    torch.cuda.synchronize()
    for a, b in zip(got, wants):
        assert _max_err(a, b) <= 1e-4 * _scale(b)


@pytest.mark.parametrize("shared", [False, True])
def test_sampled_matmul_batched_grad_matches_plain(cuda, shared):
    mu, _, rho = _posterior((70, 90), cuda, seed=12)
    mu.requires_grad_(True)
    rho.requires_grad_(True)
    shape = (33, 90) if shared else (4, 33, 90)
    x = torch.randn(shape, device=cuda, requires_grad=True)
    g = torch.randn((4, 33, 70), device=cuda)
    counts = (kb.sampled_matmul_batched.launches,
              kb.sampled_matmul_dx_batched.launches,
              kb.sampled_matmul_dw_batched.launches)
    got = torch.autograd.grad(kb.sampled_matmul_batched(3, x, mu, rho, 4),
                              (x, mu, rho), g)
    assert (kb.sampled_matmul_batched.launches,
            kb.sampled_matmul_dx_batched.launches,
            kb.sampled_matmul_dw_batched.launches) == tuple(
                c + 1 for c in counts)
    want = torch.autograd.grad(
        kb.sampled_matmul_batched_plain(3, x, mu, sigma_from_rho(rho), 4),
        (x, mu, rho), g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _max_err(a, b) <= 1e-4 * _scale(b)


# --- K-B, K-D and K-E: split-TF32 products --------------------------------

# the head at S = 1, 4, 10; then the split's edges: K (forward) and N (dx)
# below one slice, one stage, and just under and over the eight slices of
# 2048; N (forward) and K (dx) at one column, 1000 (ragged on the 48-wide
# tile) and 1001; M at one row, one past the 128-row tile, and three tiles
# (for K-E: N and K ragged on its 128 x 128 tile, M past its 32-row
# chunks)
_SPLIT_HEAD = [(s, 128, 1000, 2048) for s in (1, 4, 10)]
_SPLIT_EDGES = [(2, m, n, k) for k in (3, 8, 2047, 2049)
                for n in (1, 1000, 1001) for m in (1, 129, 300)]


@pytest.mark.parametrize("s,m,n,k", _SPLIT_HEAD + _SPLIT_EDGES)
def test_split_tf32_kernels_match_plain(cuda, s, m, n, k):
    """K-B and K-D (both with the reduction split over a cluster) and K-E
    (lane sums) against their plain versions within 1e-4 x max|plain|
    (three TF32 products in another order than cuBLAS's f32 sums), x per
    lane and shared; one launch each; lane 0 (K-E: one lane) is the single
    draw and a second call gives the same bits."""
    mu, sigma, rho = _posterior((n, k), cuda, seed=21)
    gen = torch.Generator().manual_seed(22)
    x = torch.randn((s, m, k), generator=gen).to(cuda)
    g = torch.randn((s, m, n), generator=gen).to(cuda)
    seed = 0x5EED_0000_0000_0007 + k
    before = (kb.sampled_matmul_batched.launches,
              kb.sampled_matmul_dx_batched.launches)
    out = kb.sampled_matmul_batched(seed, x, mu, rho, s,
                                    out_dtype=torch.float32)
    dx = kb.sampled_matmul_dx_batched(seed, g, mu, sigma)
    assert (kb.sampled_matmul_batched.launches,
            kb.sampled_matmul_dx_batched.launches) == (before[0] + 1,
                                                       before[1] + 1)
    shared = kb.sampled_matmul_batched(seed, x[0], mu, rho, s,
                                       out_dtype=torch.float32)
    wants = (kb.sampled_matmul_batched_plain(seed, x, mu, sigma, s),
             kb.sampled_matmul_batched_plain(seed, x[0], mu, sigma, s),
             kb.sampled_matmul_dx_batched_plain(seed, g, mu, sigma))
    for got, want in zip((out, shared, dx), wants):
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert _max_err(got, want) <= 1e-4 * _scale(want)
    assert torch.equal(out[0], sampled_matmul(seed, x[0], mu, rho,
                                              out_dtype=torch.float32))
    assert torch.equal(dx[0], kb.sampled_matmul_dx(seed, g[0], mu, sigma))
    assert torch.equal(out, kb.sampled_matmul_batched(
        seed, x, mu, rho, s, out_dtype=torch.float32))
    assert torch.equal(dx, kb.sampled_matmul_dx_batched(seed, g, mu, sigma))
    for xl in (x, x[0]):
        before = kb.sampled_matmul_dw_batched.launches
        dw = kb.sampled_matmul_dw_batched(seed, g, xl)
        assert kb.sampled_matmul_dw_batched.launches == before + 1
        for got, want in zip(dw, kb.sampled_matmul_dw_batched_plain(seed, g,
                                                                    xl)):
            torch.cuda.synchronize()
            assert got.shape == want.shape
            assert _max_err(got, want) <= 1e-4 * _scale(want)
        for a, b in zip(dw, kb.sampled_matmul_dw_batched(seed, g, xl)):
            assert torch.equal(a, b)
    for a, b in zip(kb.sampled_matmul_dw_batched(seed, g[:1], x[0]),
                    kb.sampled_matmul_dw(seed, g[0], x[0])):
        assert torch.equal(a, b)


# the draw loop's head input is bf16: K-E reads it as it is
@pytest.mark.parametrize("s,m,n,k", [(1, 128, 1000, 2048), (4, 128, 1000, 2048),
                                     (1, 7, 63, 127), (3, 257, 65, 129)])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_dw_reads_bf16_x_as_its_f32_copy(cuda, s, m, n, k, shared, offset):
    """K-E on a bf16 x gives the bits it gives on x's f32 copy (the TF32
    split of a bf16 value is exact, so the product with its lo part adds
    zeros), within 1e-4 x max|plain| of the plain version; contiguous
    views at an odd offset load as well."""
    gen = torch.Generator().manual_seed(23)
    rows = 1 if shared else s
    flat = torch.randn(rows * m * k + offset, generator=gen).to(cuda)
    x = flat.bfloat16()[offset:].view((m, k) if shared else (s, m, k))
    g = torch.randn((s, m, n), generator=gen).to(cuda)
    seed = 0x5EED_0000_0000_0009 + k
    before = kb.sampled_matmul_dw_batched.launches
    got = kb.sampled_matmul_dw_batched(seed, g, x)
    assert kb.sampled_matmul_dw_batched.launches == before + 1
    copy = kb.sampled_matmul_dw_batched(seed, g, x.float())
    for a, b in zip(got, copy):
        assert torch.equal(a, b)
    for a, b in zip(got, kb.sampled_matmul_dw_batched_plain(seed, g, x)):
        torch.cuda.synchronize()
        assert _max_err(a, b) <= 1e-4 * _scale(b)


def _device_kernel_names(fn):
    """Names of the device kernels that one call of ``fn`` launches (a
    profiler session that records nothing is taken again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        if names:
            return names
    raise AssertionError("the profiler recorded no device kernel")


@pytest.mark.parametrize("n", [1, 5, 4099, 300_001])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_single_draw_takes_softplus_in_the_kernel(cuda, n, out_dtype):
    """sample_gaussian is one K-A launch in its rho mode: no torch softplus
    runs, and the draw equals the plain version's (softplus in torch) within
    1e-5 in f32, one ulp in bf16; rho above softplus's threshold of 20 and
    far below zero included."""
    mu, _, rho = _posterior((n,), cuda, seed=23)
    rho[: min(n, 2)] = torch.tensor([25.0, -40.0][: min(n, 2)], device=cuda)
    before = ka.sample_scaled_normals_batch.launches
    got = []
    names = _device_kernel_names(
        lambda: got.append(ka.sample_gaussian(31, mu, rho, out_dtype)))
    assert ka.sample_scaled_normals_batch.launches == before + 1
    assert any("batch_sample_kernel" in name for name in names)
    assert not any("softplus" in name.lower() for name in names), names
    want = sample_scaled_normals_batch_plain(31, mu, sigma_from_rho(rho), 1,
                                             out_dtype)[0]
    if out_dtype == torch.float32:
        assert _max_err(got[0], want) <= 1e-5
    else:
        ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
        assert bool(((got[0].float() - want.float()).abs() <= ulp).all())


def _int8_operands(m, n, k, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (m, k), dtype=torch.uint8, device=device,
                      generator=g)
    w = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=device,
                      generator=g)
    bias = torch.randn(n, device=device, generator=g)
    # output scale for an output spread of ~40 quanta around the zero point
    out_scale = 0.02 * 0.01 * 74 * 74 * k ** 0.5 / 40
    return x, w, bias, out_scale


@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (37, 64, 147), (300, 1000, 100),
                                   (129, 65, 576), (250, 1000, 2048),
                                   (1000, 70, 4608)])
@pytest.mark.parametrize("x_zp,with_bias", [(128, False), (128, True),
                                            (117, False), (140, True)])
def test_qmatmul_matches_plain(cuda, m, n, k, x_zp, with_bias):
    x, w, bias, out_scale = _int8_operands(m, n, k, cuda)
    bias = bias if with_bias else None
    before = kf.qmatmul_requant.launches
    got = kf.qmatmul_requant(x, 0.02, x_zp, w, 0.01, bias, out_scale, 128)
    want = kf.qmatmul_requant_plain(
        x, w, *kf.requant_args(w, x_zp, 0.02, 0.01, bias, out_scale), 128)
    torch.cuda.synchronize()
    assert kf.qmatmul_requant.launches == before + 1
    # integer product and the same f32 epilogue: bit for bit
    assert torch.equal(got, want)


def test_qmatmul_unaligned_view(cuda):
    """A contiguous view at an odd offset (copied to an aligned buffer for
    the tensor map) gives the same bytes."""
    x, w, bias, out_scale = _int8_operands(65, 48, 64, cuda)
    xv = x.reshape(-1)[1:1 + 64 * 64].reshape(64, 64)
    got = kf.qmatmul_requant(xv, 0.02, 120, w, 0.01, bias, out_scale, 128)
    want = kf.qmatmul_requant_plain(
        xv, w, *kf.requant_args(w, 120, 0.02, 0.01, bias, out_scale), 128)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_qmatmul_raises_on_bad_input(cuda):
    x, w, bias, out_scale = _int8_operands(8, 4, 32, cuda)
    args = (0.02, 128)
    with pytest.raises(ValueError, match="uint8"):
        kf.qmatmul_requant(x.to(torch.int8), *args, w, 0.01, None, 0.1, 128)
    with pytest.raises(ValueError, match="uint8"):
        kf.qmatmul_requant(x, *args, w.to(torch.uint8), 0.01, None, 0.1, 128)
    with pytest.raises(ValueError, match="one CUDA device"):
        kf.qmatmul_requant(x, *args, w.cpu(), 0.01, None, 0.1, 128)
    with pytest.raises(ValueError, match="contiguous"):
        kf.qmatmul_requant(x.t(), *args, w[:, :8].contiguous(), 0.01, None,
                           0.1, 128)
    with pytest.raises(ValueError, match="bias"):
        kf.qmatmul_requant(x, *args, w, 0.01, bias[:2], 0.1, 128)


@pytest.mark.parametrize("k,stride,pad,x_zp", [(7, 2, 3, 128), (3, 1, 1, 117),
                                               (3, 2, 1, 100), (1, 2, 0, 90),
                                               (1, 1, 0, 128)])
def test_qconv_on_the_card_matches_the_cpu(cuda, k, stride, pad, x_zp):
    """The quantized conv route (im2col + K-F on the card) equals the same
    route on the CPU (plain version), zero-point borders included."""
    g = torch.Generator().manual_seed(k)
    x = torch.randint(0, 256, (2, 16, 15, 15), dtype=torch.uint8, generator=g)
    w = torch.randint(-128, 128, (24, 16, k, k), dtype=torch.int8,
                      generator=g)
    b = torch.randn(24, generator=g)
    want = q.qconv(x, 0.05, x_zp, w, 0.01, b, 0.05 * k, 128, stride=stride,
                   padding=pad)
    got = q.qconv(x.to(cuda), 0.05, x_zp, w.to(cuda), 0.01, b.to(cuda),
                  0.05 * k, 128, stride=stride, padding=pad)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# (M, N, K) of the CIFAR ResNet's INT8 forward at batch 128, 32x32 (the
# stem's K = 27 and the head's N = 10 off the tiles; the wrapper widens K to
# 32) and of the SCNN's at batch 1 (K = 9 widened to 16; the 9216 -> 128
# head at M = 1)
_ZOO_KF_SHAPES = [(131072, 16, 27), (131072, 16, 144), (32768, 32, 144),
                  (32768, 32, 288), (8192, 64, 288), (8192, 64, 576),
                  (128, 10, 64), (676, 32, 9), (576, 64, 288),
                  (1, 128, 9216), (1, 10, 128)]


@pytest.mark.parametrize("m,n,k", _ZOO_KF_SHAPES)
def test_qmatmul_at_the_small_zoo_shapes(cuda, m, n, k):
    x, w, bias, out_scale = _int8_operands(m, n, k, cuda, seed=m + n + k)
    before = kf.qmatmul_requant.launches
    got = kf.qmatmul_requant(x, 0.02, 128, w, 0.01, bias, out_scale, 128)
    want = kf.qmatmul_requant_plain(
        x, w, *kf.requant_args(w, 128, 0.02, 0.01, bias, out_scale), 128)
    torch.cuda.synchronize()
    assert kf.qmatmul_requant.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [432, 36_864])
def test_sampler_kernels_at_the_cifar_layer_sizes(cuda, n):
    """K-A (rho mode, and S = 4) and K-C (both modes) at the CIFAR ResNet's
    smallest (the stem, 16x3x3x3) and largest (64x64x3x3) conv."""
    mu, sigma, rho = _posterior((n,), cuda, seed=n)
    got = ka.sample_gaussian(41, mu, rho, torch.float32)
    want = sample_scaled_normals_batch_plain(41, mu, sigma, 1,
                                             torch.float32)[0]
    assert _max_err(got, want) <= 1e-5
    got = sample_scaled_normals_batch(43, mu, sigma, 4, torch.float32)
    want = sample_scaled_normals_batch_plain(43, mu, sigma, 4,
                                             torch.float32)
    assert _max_err(got, want) <= 1e-5
    g = torch.randn((4, n), generator=torch.Generator().manual_seed(n)).to(
        cuda)
    want = ka.dsigma_plain(47, g)
    assert _max_err(ka.dsigma(47, g), want) <= 1e-5 * _scale(want)
    want = ka.drho_plain(53, g[0], rho)
    assert _max_err(ka.drho(53, g[0], rho), want) <= 1e-5 * _scale(want)
    torch.cuda.synchronize()


# --- K-G: the per-draw GEMM ---------------------------------------------------

_KG_DTYPES = [torch.bfloat16, torch.float32, torch.int8]


def _kg_rand(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, dtype=torch.int8,
                             generator=g).to(device)
    return torch.randn(shape, generator=g).to(dtype).to(device)


def _kg_check(got, want, dtype):
    """int8 bit for bit; f32 1e-4 x max|plain| (order of summation); bf16
    one ulp of the largest value (one rounding of an f32 sum, and one more
    after the bias)."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.int8:
        assert torch.equal(got, want)
        return
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    assert _max_err(got, want) <= tol * _scale(want)


# (B, S, O, C, P): P = 49 and 196 are ResNet-50's 7x7 and 14x14 maps (rows
# of 98 and 392 bytes in bf16), C and O off the 16- and 64-wide tiles
_KG_SHAPES = [(2, 3, 5, 7, 49), (3, 2, 70, 33, 50), (1, 1, 64, 64, 64),
              (2, 3, 129, 65, 196), (2, 2, 17, 130, 7), (1, 4, 256, 96, 784),
              # x in slabs (C a multiple of 8, rows of 98 bytes), with one
              # and two consumer warpgroups and a ring that wraps; x
              # resident (C <= 512, O > 128) with a weight ring that wraps
              (2, 3, 70, 64, 49), (3, 2, 40, 72, 49), (2, 2, 96, 640, 49),
              (2, 3, 200, 320, 49)]


@pytest.mark.parametrize("dtype", _KG_DTYPES)
@pytest.mark.parametrize("shape", _KG_SHAPES)
@pytest.mark.parametrize("shared_x", [False, True])
def test_mc_gemm_matches_plain(cuda, dtype, shape, shared_x):
    B, S, O, C, P = shape
    x = _kg_rand((B, C, P) if shared_x else (B, S, C, P), dtype, cuda, 0)
    w = _kg_rand((S, O, C), dtype, cuda, 1)
    bias = None if dtype == torch.int8 else _kg_rand((S, O), dtype, cuda, 2)
    before = kg.mc_gemm.launches
    got = kg.mc_gemm(x, w, bias)
    assert kg.mc_gemm.launches == before + 1
    _kg_check(got, kg.mc_gemm_plain(x, w, bias), dtype)


@pytest.mark.parametrize("dtype", _KG_DTYPES)
@pytest.mark.parametrize("shape", _KG_SHAPES[:4])
def test_pointwise_gemm_matches_plain(cuda, dtype, shape):
    """One weight for the whole batch, with and without a bias, and from
    a view at an odd offset (the narrowest loads)."""
    B, S, O, C, P = shape
    x = _kg_rand((B * S, C, P), dtype, cuda, 3)
    w = _kg_rand((O, C), dtype, cuda, 4)
    bias = None if dtype == torch.int8 else _kg_rand((O,), dtype, cuda, 5)
    before = kg.pointwise_gemm.launches
    for b in (None, bias):
        _kg_check(kg.pointwise_gemm(x, w, b),
                  kg.mc_gemm_plain(x, w, b)[:, 0], dtype)
    odd = _kg_rand((x.numel() + 3,), dtype, cuda, 6)[3:].reshape(x.shape)
    wodd = _kg_rand((w.numel() + 1,), dtype, cuda, 7)[1:].reshape(w.shape)
    _kg_check(kg.pointwise_gemm(odd, wodd, bias),
              kg.mc_gemm_plain(odd, wodd, bias)[:, 0], dtype)
    assert kg.pointwise_gemm.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_matmul_is_the_probe_at_a_small_size(cuda, dtype):
    a = _kg_rand((200, 136), dtype, cuda, 8)
    b = _kg_rand((136, 328), dtype, cuda, 9)
    got = kg.matmul(a, b)
    torch.cuda.synchronize()
    if dtype == torch.int8:
        assert torch.equal(got, (a.double() @ b.double()).to(torch.int32))
    else:
        want = (a.float() @ b.float()).to(dtype)
        assert _max_err(got, want) <= 2.0 ** -7 * _scale(want)


def test_mc_gemm_raises_on_bad_input(cuda):
    x = torch.randn(2, 3, 8, 16, device=cuda)
    w = torch.randn(3, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kg.mc_gemm(x.transpose(2, 3).contiguous().transpose(2, 3), w)
    with pytest.raises(ValueError):
        kg.mc_gemm(x, w.cpu())
    with pytest.raises(ValueError):
        kg.mc_gemm(x.half(), w.half())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", _KG_SHAPES[:4])
@pytest.mark.parametrize("shared", ["none", "x", "w"])
def test_mc_gemm_backward_matches_the_cpu(cuda, dtype, shape, shared):
    """K-G's gradients on the card (dx through K-G, one launch counted on
    the wrapper) against the same autograd on a CPU copy (the plain
    version), in f32 (1e-4 x max, order of summation) and bf16 (two ulps
    of the largest value: the product and dx each round once)."""
    B, S, O, C, P = shape
    x = _kg_rand((B, C, P) if shared == "x" else (B, S, C, P), dtype, cuda, 13)
    w = _kg_rand((1 if shared == "w" else S, O, C), dtype, cuda, 14)
    bias = _kg_rand((w.shape[0], O), dtype, cuda, 15)
    g = _kg_rand((B, S, O, P), dtype, cuda, 16)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        t = [a.detach().to(dev).requires_grad_(True) for a in (x, w, bias)]
        before = kg.mc_gemm.launches
        (kg.mc_gemm(*t) * g.to(dev)).sum().backward()
        if dev == cuda:
            assert kg.mc_gemm.launches == before + 2
        grads.append([a.grad for a in t])
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for got, want in zip(*grads):
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _max_err(got.cpu(), want) <= tol * _scale(want)


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_pointwise_emission_on_the_card_matches_cudnn(cuda, monkeypatch,
                                                      compute_dtype):
    """conv_nd and conv_draws with pointwise_dot=True launch K-G and give
    what the default route gives (f32 with TF32 off; bf16 within two ulps
    of the largest value: two libraries' roundings)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    S, B, C, O = 3, 2, 24, 40
    x = _kg_rand((B, S * C, 7, 7), torch.float32, cuda, 10)
    w = _kg_rand((S, O, C, 1, 1), torch.float32, cuda, 11)
    b = _kg_rand((S, O), torch.float32, cuda, 12)
    tol = 1e-4 if compute_dtype is None else 2.0 ** -6
    before = kg.mc_gemm.launches, kg.pointwise_gemm.launches
    for xs in (x, x[:, :C].contiguous()):
        got = conv_ops.conv_draws(xs, w, b, compute_dtype=compute_dtype,
                                  pointwise_dot=True)
        want = conv_ops.conv_draws(xs, w, b, compute_dtype=compute_dtype)
        assert _max_err(got, want) <= tol * _scale(want)
    got = conv_ops.conv_nd(x, w[0].repeat(1, S, 1, 1), b[0],
                           compute_dtype=compute_dtype, pointwise_dot=True)
    want = conv_ops.conv_nd(x, w[0].repeat(1, S, 1, 1), b[0],
                            compute_dtype=compute_dtype)
    assert _max_err(got, want) <= tol * _scale(want)
    assert (kg.mc_gemm.launches, kg.pointwise_gemm.launches) == (
        before[0] + 2, before[1] + 1)


# --- model surgery on the card -----------------------------------------------


def _narrow_resnets(device, seed=0):
    """A narrow deterministic ResNet (Bottleneck, one block a stage, 10
    classes; BN statistics from one training-mode batch) and a fresh
    Bayesian twin of it, on ``device``."""
    from bayesian_torch_tpu_torch.models import _large_resnet as res

    det = res.LargeResNet(res.Bottleneck, [1, 1, 1, 1], 10, estimator=None,
                          generator=torch.Generator().manual_seed(seed),
                          device=device)
    det.train()
    with torch.no_grad():
        det(torch.randn(8, 3, 32, 32,
                        generator=torch.Generator().manual_seed(seed + 1)
                        ).to(device))
    bayes = res.LargeResNet(res.Bottleneck, [1, 1, 1, 1], 10,
                            estimator="Reparameterization",
                            generator=torch.Generator().manual_seed(seed + 2),
                            device=device)
    return det.eval(), bayes.eval()


def test_moped_at_small_delta_on_the_card_matches_its_cpu_copy(cuda,
                                                               monkeypatch):
    """MOPED at delta = 1e-4 on the card and on a CPU copy: the same
    posteriors (rho to 1e-6 relative: expm1 and log of two libraries),
    priors and BN state, the same KL (1e-5 relative), and the card's MC-4
    mean (one K-A launch) within 2^-6 x max|logit| of the deterministic
    logits (f32, TF32 off)."""
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import get_kl_loss
    from bayesian_torch_tpu_torch.parallel import mc_forward
    from bayesian_torch_tpu_torch.utils import MOPED

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    det, bayes = _narrow_resnets(cuda)
    det_cpu, bayes_cpu = _narrow_resnets("cpu")
    det_cpu.load_state_dict(det.state_dict())
    for model, d in ((bayes, det), (bayes_cpu, det_cpu)):
        MOPED(model, d, None, delta=1e-4)
    cpu = dict(bayes_cpu.named_buffers(), **dict(
        bayes_cpu.named_parameters()))
    for name, t in list(bayes.named_parameters()) + list(
            bayes.named_buffers()):
        want = cpu[name]
        assert t.device.type == "cuda" and t.shape == want.shape, name
        rtol = 1e-6 if "rho" in name else 0
        assert torch.allclose(t.cpu().double(), want.double(), rtol=rtol,
                              atol=0), name
    assert bayes.conv1.prior_weight_mu.shape == bayes.conv1.mu_kernel.shape
    kl, kl_cpu = get_kl_loss(bayes).item(), get_kl_loss(bayes_cpu).item()
    assert abs(kl - kl_cpu) <= 1e-5 * abs(kl_cpu)
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = det_cpu(x)
    before = ka.sample_scaled_normals_batch.launches
    got = mc_forward(bayes, x.to(cuda), 4, reduce="mean", return_kl=False)
    assert ka.sample_scaled_normals_batch.launches == before + 1
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 2 ** -6 * scale


def test_converted_model_presample_is_the_plain_sampler(cuda):
    """The noise contract on a converted model: the one K-A launch of
    ``_presample_layers`` gives, element by element, what
    ``sample_scaled_normals_batch``'s plain version gives for the same
    seed and flat posterior (within 1e-5: the last ulp of two CUDA
    libraries' log and cos)."""
    from bayesian_torch_tpu_torch.models import dnn_to_bnn
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )
    from bayesian_torch_tpu_torch.ops.sampling import draw_seed
    from bayesian_torch_tpu_torch.parallel import mc as tmc

    model, _ = _narrow_resnets(cuda)
    dnn_to_bnn(model, {"prior_mu": 0.0, "prior_sigma": 1.0,
                       "posterior_mu_init": 0.0, "posterior_rho_init": -3.0,
                       "type": "Reparameterization", "moped_enable": True,
                       "moped_delta": 0.5})
    layers = list(iter_bayesian_layers(model))
    gen = layers[0].generator
    state = gen.get_state()
    before = ka.sample_scaled_normals_batch.launches
    with torch.no_grad():
        touched = tmc._presample_layers(model, 4)
    assert ka.sample_scaled_normals_batch.launches == before + 1
    gen.set_state(state)
    posts = [tmc._posterior(layer) for layer in layers]
    with torch.no_grad():
        want = sample_scaled_normals_batch_plain(
            draw_seed(gen), torch.cat([mu.reshape(-1) for mu, _ in posts]),
            torch.cat([sigma_from_rho(rho).reshape(-1) for _, rho in posts]),
            4, torch.float32)
    got = torch.cat([attrs["_presampled_w"].reshape(4, -1)
                     for _, attrs in touched], dim=1)
    assert [layer for layer, _ in touched] == layers
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5


# K-F at the GEMM shapes of the INT8 Flipout ResNet-50 path (bs128, 224^2:
# each layer's perturbation GEMM has the mean's shape) and of the two
# probe convs of chip_smoke.py: the ResNeXt-like grouped conv (one GEMM a
# group, K = 8 * 9 widened to 80) and the DCGAN-like transposed conv (K =
# 512 * 16 over the zero-point-inserted input)
_INT8_FLIPOUT_SHAPES = [
    (128 * 112 * 112, 64, 160), (128 * 56 * 56, 64, 576),
    (128 * 56 * 56, 256, 64), (128 * 28 * 28, 128, 1152),
    (128 * 14 * 14, 1024, 256), (128 * 7 * 7, 512, 4608),
    (128, 1000, 2048), (32 * 56 * 56, 8, 80), (64 * 32 * 32, 256, 8192)]


@pytest.mark.parametrize("m,n,k", _INT8_FLIPOUT_SHAPES)
def test_qmatmul_matches_plain_at_int8_flipout_shapes(cuda, m, n, k):
    x, w, bias, out_scale = _int8_operands(m, n, k, cuda, seed=m % 97)
    got = kf.qmatmul_requant(x, 0.02, 117, w, 0.01, bias, out_scale, 128)
    want = kf.qmatmul_requant_plain(
        x, w, *kf.requant_args(w, 117, 0.02, 0.01, bias, out_scale), 128)
    assert torch.equal(got, want)


def _qconv_plain(monkeypatch):
    """``ops.int8``'s GEMM on K-F's plain version, on the card."""
    def plain(x_q, x_scale, x_zp, w_q, w_scale, bias, out_scale, out_zp):
        args = kf.requant_args(w_q, x_zp, x_scale, w_scale, bias, out_scale)
        return kf.qmatmul_requant_plain(x_q, w_q, *args, out_zp)

    monkeypatch.setattr(q, "qmatmul_requant", plain)


@pytest.mark.parametrize("case", [
    dict(x=(4, 64, 14, 14), w=(64, 2, 3, 3), groups=32, padding=1),
    dict(x=(2, 32, 9, 9), w=(32, 1, 3, 3), groups=32, stride=2, padding=1),
    dict(x=(4, 64, 8, 8), w=(64, 32, 4, 4), stride=2, padding=1,
         transposed=True),
    dict(x=(2, 16, 5, 5), w=(16, 4, 3, 3), groups=2, stride=2, dilation=2,
         output_padding=1, transposed=True)])
def test_grouped_and_transposed_qconv_match_plain_route(cuda, monkeypatch,
                                                       case):
    """Grouped and transposed int8 convs through K-F equal the same
    lowering on K-F's plain version bit for bit, one launch a group."""
    case = dict(case)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randint(0, 256, case.pop("x"), dtype=torch.uint8, device=cuda,
                      generator=g)
    w = torch.randint(-128, 128, case.pop("w"), dtype=torch.int8,
                      device=cuda, generator=g)
    o = w.shape[1] * case.get("groups", 1) if case.get("transposed") \
        else w.shape[0]
    bias = torch.randn(o, device=cuda, generator=g)
    args = (0.02, 117, w, 0.01, bias, 0.3, 128)
    before = kf.qmatmul_requant.launches
    got = q.qconv(x, *args, **case)
    torch.cuda.synchronize()
    assert kf.qmatmul_requant.launches == before + case.get("groups", 1)
    _qconv_plain(monkeypatch)
    assert torch.equal(got, q.qconv(x, *args, **case))


@pytest.mark.parametrize("name", ["QuantizedConv2dFlipout",
                                  "QuantizedConvTranspose2dFlipout",
                                  "QuantizedLinearFlipout"])
def test_quantized_flipout_layer_matches_cpu(cuda, name):
    """A quantized Flipout layer on the card with a frozen perturbation
    and reseeded generators (the same sign salts) equals its CPU copy bit
    for bit: integer signs from the hash, K-F equal to its plain
    version."""
    from torch import nn

    from bayesian_torch_tpu_torch import layers as L
    from bayesian_torch_tpu_torch.models.bnn_to_qbnn import bnn_to_qbnn
    from bayesian_torch_tpu_torch.quantization import (
        freeze_quantized_draws, prepare)

    float_name = name[len("Quantized"):]
    args = (12, 7) if "Linear" in float_name else (8, 6, 3, 2, 1)
    shape = (5, 12) if "Linear" in float_name else (2, 8, 9, 9)
    layer = getattr(L, float_name)(
        *args, generator=torch.Generator().manual_seed(0))
    holder = nn.ModuleDict(dict(l=layer)).eval()
    prepare(holder)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        holder["l"](x)
    bnn_to_qbnn(holder)
    freeze_quantized_draws(holder)
    cpu = holder["l"]
    card = copy.deepcopy(cpu).to(cuda)
    card._refresh_scales()
    outs = []
    for mod, xs in ((cpu, x), (card, x.to(cuda))):
        mod.generator.manual_seed(2)
        mod.q_output = True
        with torch.no_grad():
            outs.append(mod(xs, return_kl=False).q.cpu())
    assert type(cpu).__name__ == name
    assert torch.equal(outs[0], outs[1])


# --- the Bayesian LSTM: K-A lanes and K-C dsigma at its shapes -------------

# config #4 (hidden 64, input 1): ih W 256x1, hh W 256x64, the 256 biases;
# T = 64 lanes a forward, S*T = 1280 under the draw axis at MC-20
LSTM_SHAPES = [(256, 1), (256, 64), (256,)]


@pytest.mark.parametrize("lanes", [64, 1280])
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_lane_kernels_match_plain(cuda, shape, lanes):
    """K-A with one lane per step (and per draw and step) and K-C dsigma
    over those lanes against their plain versions, f32."""
    mu, sigma, _ = _posterior(shape, cuda, seed=lanes)
    seed = 0x5EED_0000_0000_0013
    got = sample_scaled_normals_batch(seed, mu, sigma, lanes, torch.float32)
    want = sample_scaled_normals_batch_plain(seed, mu, sigma, lanes,
                                             torch.float32)
    g = torch.randn((lanes,) + shape, generator=torch.Generator()
                    .manual_seed(3)).to(cuda)
    dsig = ka.dsigma(seed, g)
    dsig_plain = ka.dsigma_plain(seed, g)
    torch.cuda.synchronize()
    assert got.shape == (lanes,) + shape
    assert (got - want).abs().max().item() <= 1e-5
    limit = 1e-5 * max(1.0, dsig_plain.abs().max().item())
    assert (dsig - dsig_plain).abs().max().item() <= limit


@pytest.mark.parametrize("per_step", [True, False])
@pytest.mark.parametrize("estimator", ["Reparameterization", "Flipout"])
def test_lstm_on_the_card_matches_a_cpu_copy(cuda, estimator, per_step):
    """One forward and backward of the LSTM on the card (K-A lanes, K-C)
    against a CPU copy on the plain versions: the same generator state
    gives the same seeds, and the counter hash the same noise."""
    from bayesian_torch_tpu_torch import layers as L

    cpu = getattr(L, "LSTM" + estimator)(
        3, 16, generator=torch.Generator().manual_seed(0),
        resample_per_step=per_step)
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn((5, 9, 3), generator=torch.Generator().manual_seed(1))
    outs = []
    for mod, xs in ((cpu, x), (card, x.to(cuda))):
        mod.generator.manual_seed(2)
        out, (_, c), kl = mod(xs)
        (out.sum() + (c * c).sum() + kl).backward()
        outs.append([out, c] + [p.grad for p in mod.parameters()])
    for want, got in zip(*outs):
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)


# --- the counter window of K-A and K-C (mc_forward(mesh=), shard_params_tp)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rho_mode", [False, True])
@pytest.mark.parametrize("n,shards", [(4096, 4), (3 * 1001, 3)])
def test_windowed_sampler_equals_the_whole_launch(cuda, out_dtype, rho_mode,
                                                   n, shards):
    """K-A with a window (lane0, lane stride, offset): lanes [2, 5) of a
    5-lane launch over n elements, and each dim-0 shard's rows of them,
    equal those elements of the whole launch bit for bit, in both of K-A's
    modes (sigma given, or rho with the softplus in the kernel)."""
    mu, sigma, rho = _posterior((n,), cuda, seed=3)
    seed, S = 0x0DDB_A11_5EED, 5
    if rho_mode:
        whole = torch.stack([ka.sample_gaussian(
            seed, mu, rho, out_dtype, window=(s, n, 0)) for s in range(S)])
        assert torch.equal(whole[0], ka.sample_gaussian(seed, mu, rho,
                                                        out_dtype))
    else:
        whole = sample_scaled_normals_batch(seed, mu, sigma, S, out_dtype)
        assert torch.equal(
            sample_scaled_normals_batch(seed, mu, sigma, 3, out_dtype,
                                        window=(2, n, 0)), whole[2:])
    rows = n // shards
    for r in range(shards):
        part = slice(r * rows, (r + 1) * rows)
        if rho_mode:
            got = torch.stack([ka.sample_gaussian(
                seed, mu[part], rho[part], out_dtype,
                window=(s, n, r * rows)) for s in range(2, S)])
        else:
            got = sample_scaled_normals_batch(
                seed, mu[part], sigma[part], 3, out_dtype,
                window=(2, n, r * rows))
        torch.cuda.synchronize()
        assert torch.equal(got, whole[2:, part]), r


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,shards", [(4096, 4), (3 * 1001, 3)])
def test_windowed_noise_grad_equals_the_whole_launch(cuda, g_dtype, n,
                                                      shards):
    """K-C with a window: dsigma over lanes [2, 5) of a shard's rows, and
    drho of one draw's shard, equal those elements of the whole launch's
    gradient (the cotangent zero elsewhere) bit for bit."""
    g = torch.Generator().manual_seed(9)
    _, _, rho = _posterior((n,), cuda, seed=4)
    seed, S = 0x5EED_0F_C0DE, 5
    rows = n // shards
    for r in range(shards):
        part = slice(r * rows, (r + 1) * rows)
        cot = torch.randn((3, rows), generator=g).to(cuda, g_dtype)
        placed = torch.zeros((S, n), device=cuda, dtype=g_dtype)
        placed[2:, part] = cot
        got = ka.dsigma(seed, cot, window=(2, n, r * rows))
        assert torch.equal(got, ka.dsigma(seed, placed)[part]), r
        one = cot[0].float()
        placed1 = torch.zeros(n, device=cuda)
        placed1[part] = one
        got = ka.drho(seed, one, rho[part], window=(0, n, r * rows))
        assert torch.equal(got, ka.drho(seed, placed1, rho)[part]), r
    torch.cuda.synchronize()
