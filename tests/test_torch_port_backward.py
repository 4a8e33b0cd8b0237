"""Backward of the port's sampler and sampled-GEMM ops.

- Kernel algebra against the JAX package: ``jax.vjp`` of each Pallas
  function, run in interpret mode, against the port's backward algebra on
  the eps the Pallas forward drew (recovered from its output, as
  test_torch_port_ops.py does for the forwards): #2 ``_batch_dsigma_kernel``,
  #3/#4 ``_sample_kernel``/``_drho_kernel``, #6/#7 ``_dx_kernel``/``_dw_kernel``.
- Each plain backward against torch autograd of its plain forward.
- The same at ragged sizes (ResNet-50's stem of 9,408 weights, the edges
  of the Pallas tiles, a few elements), S = 4, beside the plain backward
  of the port's own forward.
- The public ops on CPU tensors: autograd Functions that save the seed,
  never eps, and launch nothing.

Inputs come from numpy with fixed seeds, f32; tolerances per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_torch_tpu.ops.pallas.sampled_matmul import sampled_matmul_pallas
from bayesian_torch_tpu.ops.pallas.sampled_weights import (
    sample_gaussian_pallas,
)
from bayesian_torch_tpu.ops.pallas.sampled_weights import (
    sample_scaled_normals_batch as jax_batch_sampler,
)
from bayesian_torch_tpu_torch.ops import sampling as ts
from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from tests import _torch_port  # noqa: F401  (one torch thread per worker)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _launch_counts():
    return (ka.sample_scaled_normals_batch.launches, ka.dsigma.launches,
            ka.drho.launches, kb.sampled_matmul.launches,
            kb.sampled_matmul_dx.launches, kb.sampled_matmul_dw.launches)


# ------------------------------------------- against the Pallas VJPs


def test_batch_sampler_vjp_matches_jax_kernel():
    """#2: dsigma = sum_s g_s * eps_s; dmu = sum_s g_s."""
    rs = np.random.RandomState(0)
    n, S = 3000, 3
    mu = rs.normal(0, 0.3, n).astype(np.float32)
    sigma = rs.uniform(0.05, 0.2, n).astype(np.float32)
    g = rs.randn(S, n).astype(np.float32)
    w, vjp = jax.vjp(lambda m, s: jax_batch_sampler(
        jax.random.key(0), m, s, S, jnp.float32), mu, sigma)
    dmu_j, dsig_j = vjp(jnp.asarray(g))
    eps = _t((np.asarray(w) - mu) / sigma)
    dsig_t = ka.noise_grad(_t(g), eps.__getitem__)
    # eps recovered by a division: one rounding of w, times 1/sigma <= 20,
    # summed over 3 draws of |g| ~ 1
    np.testing.assert_allclose(dsig_t.numpy(), np.asarray(dsig_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_t(g).sum(0).numpy(), np.asarray(dmu_j),
                               rtol=1e-6, atol=1e-6)


def test_gaussian_sampler_vjp_matches_jax_kernel():
    """#3 forward, #4 backward: drho = g * eps * sigmoid(rho); dmu = g."""
    rs = np.random.RandomState(1)
    n = 3000
    mu = rs.normal(0, 0.3, n).astype(np.float32)
    rho = rs.uniform(-3.0, -1.0, n).astype(np.float32)
    g = rs.randn(n).astype(np.float32)
    w, vjp = jax.vjp(lambda m, r: sample_gaussian_pallas(
        jax.random.key(3), m, r, jnp.float32), mu, rho)
    dmu_j, drho_j = vjp(jnp.asarray(g))
    sigma = ts.sigma_from_rho(_t(rho))
    eps = (_t(w) - _t(mu)) / sigma
    drho_t = ka.drho_from_noise(_t(g), eps, _t(rho))
    # as above, 1/sigma <= 21
    np.testing.assert_allclose(drho_t.numpy(), np.asarray(drho_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(dmu_j), g)


def test_sampled_matmul_vjp_matches_jax_kernel():
    """#6 dx = g @ W; #7 dmu = g^T x, dsigma = dmu * eps; drho chained
    through softplus by torch autograd, as JAX chains it through XLA."""
    rs = np.random.RandomState(2)
    M, N, K = 30, 50, 70
    x = rs.randn(M, K).astype(np.float32)
    mu = (0.3 * rs.randn(N, K)).astype(np.float32)
    rho = rs.uniform(-2.0, -0.5, (N, K)).astype(np.float32)
    g = rs.randn(M, N).astype(np.float32)
    key = jax.random.key(5)
    W = np.asarray(sampled_matmul_pallas(key, jnp.eye(K), mu, rho,
                                         out_dtype=jnp.float32)).T
    _, vjp = jax.vjp(lambda a, m, r: sampled_matmul_pallas(
        key, a, m, r, out_dtype=jnp.float32), x, mu, rho)
    dx_j, dmu_j, drho_j = vjp(jnp.asarray(g))

    rho_t = _t(rho).requires_grad_(True)
    sigma = ts.sigma_from_rho(rho_t)
    eps = (_t(W) - _t(mu)) / sigma.detach()
    dx_t = kb.matmul_dx(_t(g), _t(mu), sigma.detach(), eps)
    dmu_t, dsig_t = kb.matmul_dw(_t(g), _t(x), eps)
    (drho_t,) = torch.autograd.grad(sigma, rho_t, dsig_t)
    # f32 sums of 30-70 products in two orders; eps recovered by a
    # division (1/sigma <= 8, |dmu| up to ~30)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dmu_t.numpy(), np.asarray(dmu_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(drho_t.numpy(), np.asarray(drho_j),
                               rtol=1e-5, atol=2e-5)


# ragged sizes: the stem's 9,408 weights, the head's bias of 1,000, the
# edges of the Pallas tiles (32,768 elements single-draw, 131,072 batch)
# and of the CUDA kernels' vector width, and a few elements
@pytest.mark.parametrize("n", [1, 3, 1000, 1001, 1023, 4097, 9408, 32_767,
                               32_769, 65_537, 131_071, 131_073, 147_457])
def test_noise_grad_at_layer_sizes_matches_jax_kernels(n):
    """#2 (S = 4) and #4 at ragged per-layer sizes: the Pallas VJPs
    (interpret mode) against the algebra of ``dsigma_plain`` and
    ``drho_plain`` on the eps the Pallas forwards drew; and those plain
    versions against the same algebra on the eps of the port's own plain
    forward (K-A's), at the same sizes."""
    rs = np.random.RandomState(n)
    S = 4
    mu = rs.normal(0, 0.3, n).astype(np.float32)
    rho = rs.uniform(-3.0, -1.0, n).astype(np.float32)
    sigma = np.asarray(ts.sigma_from_rho(_t(rho)))
    g = rs.randn(S, n).astype(np.float32)
    w, vjp = jax.vjp(lambda m, s: jax_batch_sampler(
        jax.random.key(n), m, s, S, jnp.float32), mu, sigma)
    _, dsig_j = vjp(jnp.asarray(g))
    eps = _t((np.asarray(w) - mu) / sigma)
    # eps recovered by a division: one rounding of w, times 1/sigma <= 21,
    # summed over 4 draws of |g| ~ 1
    np.testing.assert_allclose(ka.noise_grad(_t(g), eps.__getitem__).numpy(),
                               np.asarray(dsig_j), rtol=1e-5, atol=2e-5)
    w1, vjp1 = jax.vjp(lambda m, r: sample_gaussian_pallas(
        jax.random.key(n + 1), m, r, jnp.float32), mu, rho)
    _, drho_j = vjp1(jnp.asarray(g[0]))
    eps1 = (_t(w1) - _t(mu)) / _t(sigma)
    np.testing.assert_allclose(
        ka.drho_from_noise(_t(g[0]), eps1, _t(rho)).numpy(),
        np.asarray(drho_j), rtol=1e-5, atol=1e-5)

    seed = 2**40 + n
    w_t = ka.sample_scaled_normals_batch_plain(seed, _t(mu), _t(sigma), S,
                                               torch.float32)
    eps_t = (w_t - _t(mu)) / _t(sigma)
    torch.testing.assert_close(ka.dsigma_plain(seed, _t(g)),
                               ka.noise_grad(_t(g), eps_t.__getitem__),
                               rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(ka.drho_plain(seed, _t(g[0]), _t(rho)),
                               ka.drho_from_noise(_t(g[0]), eps_t[0],
                                                  _t(rho)),
                               rtol=1e-5, atol=1e-5)


# ------------------------------- plain backward == autograd of plain forward


@pytest.mark.parametrize("num_samples", [1, 4])
def test_dsigma_plain_is_autograd_of_the_plain_sampler(num_samples):
    rs = np.random.RandomState(3)
    mu = _t(rs.normal(0, 0.3, (6, 5, 7))).requires_grad_(True)
    sigma = _t(rs.uniform(0.01, 0.3, (6, 5, 7))).requires_grad_(True)
    g = _t(rs.randn(num_samples, 6, 5, 7))
    seed = 2**41 + 3
    w = ka.sample_scaled_normals_batch_plain(seed, mu, sigma, num_samples,
                                             torch.float32)
    dmu, dsig = torch.autograd.grad(w, (mu, sigma), g)
    torch.testing.assert_close(ka.dsigma_plain(seed, g), dsig, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(g.sum(0), dmu, rtol=1e-6, atol=1e-6)


def test_drho_plain_is_autograd_of_the_plain_gaussian_sampler():
    rs = np.random.RandomState(4)
    mu = _t(rs.normal(0, 0.3, 999))
    rho = _t(rs.uniform(-6.0, 2.0, 999)).requires_grad_(True)
    g = _t(rs.randn(999))
    seed = 77
    w = ka.sample_scaled_normals_batch_plain(seed, mu, ts.sigma_from_rho(rho),
                                             1, torch.float32)[0]
    (want,) = torch.autograd.grad(w, rho, g)
    # torch's softplus backward computes the sigmoid its own way
    torch.testing.assert_close(ka.drho_plain(seed, g, rho), want,
                               rtol=1e-6, atol=1e-7)


def test_sampled_matmul_plain_backward_is_autograd_of_plain_forward():
    rs = np.random.RandomState(5)
    M, N, K = 9, 13, 21
    x = _t(rs.randn(M, K)).requires_grad_(True)
    mu = _t(0.3 * rs.randn(N, K)).requires_grad_(True)
    sigma = _t(rs.uniform(0.01, 0.3, (N, K))).requires_grad_(True)
    g = _t(rs.randn(M, N))
    seed = 123
    out = kb.sampled_matmul_plain(seed, x, mu, sigma, torch.float32)
    dx, dmu, dsig = torch.autograd.grad(out, (x, mu, sigma), g)
    torch.testing.assert_close(kb.sampled_matmul_dx_plain(seed, g, mu, sigma),
                               dx, rtol=1e-5, atol=1e-6)
    got_mu, got_sig = kb.sampled_matmul_dw_plain(seed, g, x)
    torch.testing.assert_close(got_mu, dmu, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_sig, dsig, rtol=1e-5, atol=1e-6)


# ------------------------------------------------ the public ops on the CPU


def test_batch_sampler_function_saves_the_seed_not_eps():
    rs = np.random.RandomState(6)
    mu = _t(rs.normal(0, 0.3, 500)).requires_grad_(True)
    sigma = _t(rs.uniform(0.01, 0.3, 500)).requires_grad_(True)
    g = _t(rs.randn(3, 500))
    before = _launch_counts()
    w = ka.sample_scaled_normals_batch(11, mu, sigma, 3, torch.float32)
    assert type(w.grad_fn).__name__ == "_BatchSamplerBackward"
    assert w.grad_fn.saved_tensors == ()
    dmu, dsig = torch.autograd.grad(w, (mu, sigma), g)
    plain = ka.sample_scaled_normals_batch_plain(11, mu, sigma, 3,
                                                 torch.float32)
    want = torch.autograd.grad(plain, (mu, sigma), g)
    torch.testing.assert_close(dmu, want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dsig, want[1], rtol=1e-6, atol=1e-6)
    # bf16 draws: the cotangent arrives in bf16, dsigma comes back in f32
    wb = ka.sample_scaled_normals_batch(11, mu, sigma, 3)
    (dsig_b,) = torch.autograd.grad(wb, sigma, g.bfloat16())
    assert dsig_b.dtype == torch.float32
    torch.testing.assert_close(dsig_b, ka.dsigma_plain(11, g.bfloat16()),
                               rtol=0, atol=0)
    assert _launch_counts() == before  # CPU tensors: plain versions


def test_gaussian_sampler_function_matches_the_batch_sampler():
    rs = np.random.RandomState(7)
    mu = _t(rs.normal(0, 0.3, (8, 3, 3))).requires_grad_(True)
    rho = _t(rs.uniform(-5.0, -1.0, (8, 3, 3))).requires_grad_(True)
    g = _t(rs.randn(8, 3, 3))
    before = _launch_counts()
    w = ka.sample_gaussian(99, mu, rho, torch.float32)
    assert [t.shape for t in w.grad_fn.saved_tensors] == [rho.shape]
    want = ka.sample_scaled_normals_batch(
        99, mu, ts.sigma_from_rho(rho), 1, torch.float32)[0]
    torch.testing.assert_close(w, want, rtol=0, atol=0)
    dmu, d_rho = torch.autograd.grad(w, (mu, rho), g)
    dmu_w, drho_w = torch.autograd.grad(want, (mu, rho), g)
    torch.testing.assert_close(dmu, dmu_w, rtol=0, atol=0)
    torch.testing.assert_close(d_rho, drho_w, rtol=1e-6, atol=1e-7)
    wb = ka.sample_gaussian(99, mu, rho)
    assert wb.dtype == torch.bfloat16
    torch.testing.assert_close(wb, w.detach().bfloat16(), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ka.sample_gaussian(0, mu, rho[:, :, :2])
    with pytest.raises(ValueError):
        ka.drho(0, g, rho[:2])
    assert _launch_counts() == before


def test_sampled_matmul_function_backward_matches_plain_autograd():
    rs = np.random.RandomState(8)
    M, N, K = 7, 11, 19
    x = _t(rs.randn(M, K)).requires_grad_(True)
    mu = _t(0.3 * rs.randn(N, K)).requires_grad_(True)
    rho = _t(rs.uniform(-4.0, -1.0, (N, K))).requires_grad_(True)
    g = _t(rs.randn(M, N))
    before = _launch_counts()
    out = kb.sampled_matmul(5, x, mu, rho)
    assert type(out.grad_fn).__name__ == "_SampledMatmulBackward"
    saved = [tuple(t.shape) for t in out.grad_fn.saved_tensors]
    assert saved == [(M, K), (N, K), (N, K)]  # residuals x, mu, sigma
    got = torch.autograd.grad(out, (x, mu, rho), g)
    plain = kb.sampled_matmul_plain(5, x, mu, ts.sigma_from_rho(rho),
                                    torch.float32)
    want = torch.autograd.grad(plain, (x, mu, rho), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # bf16 activations: dx comes back in x's dtype
    xb = x.detach().bfloat16().requires_grad_(True)
    (dxb,) = torch.autograd.grad(kb.sampled_matmul(5, xb, mu, rho), xb,
                                 g.bfloat16())
    assert dxb.dtype == torch.bfloat16
    assert _launch_counts() == before


# --------------------------------------- K-B, K-D and K-E under a window

# (lane0, lanes of the window, first row, rows of the window) of a launch
# of 5 lanes over a (12, 7) weight: a rank's lanes of the draws, a
# tensor-parallel shard's rows, and both
_WINDOWS = {"lanes": (2, 3, 0, 12), "rows": (0, 5, 4, 4),
            "both": (2, 3, 4, 4)}


@pytest.mark.parametrize("part", sorted(_WINDOWS))
def test_windowed_sampled_matmul_is_the_block_of_the_whole_launch(part):
    """The counter window (lane0, N*K, n0*K) of K-B, K-D and K-E: the
    plain eps is the whole launch's block bit for bit; the forward, dx and
    dw through the public op's autograd are the whole launch's block (1e-6
    relative: a block's product may sum in another order); the whole
    window is the call without one, bit for bit."""
    lane0, S, n0, Nr = _WINDOWS[part]
    rs = np.random.RandomState(9)
    S_all, M, N, K, seed = 5, 3, 12, 7, 0xFEED_0000_0000_0019
    window = (lane0, N * K, n0 * K)
    lanes, rows = slice(lane0, lane0 + S), slice(n0, n0 + Nr)
    whole_eps = kb._eps(seed, (N, K), None, S_all)
    assert torch.equal(kb._eps(seed, (Nr, K), None, S, window),
                       whole_eps[lanes, rows])
    assert torch.equal(kb._eps(seed, (N, K), None, S_all, (0, N * K, 0)),
                       whole_eps)

    x_all = _t(rs.randn(S_all, M, K))
    mu_all = _t(0.3 * rs.randn(N, K))
    rho_all = _t(rs.uniform(-4.0, -1.0, (N, K)))
    g_all = _t(rs.randn(S_all, M, N))
    g_all[:, :, :n0] = 0.0  # the cotangent of the window alone
    g_all[:, :, n0 + Nr:] = 0.0
    g_all[:lane0] = 0.0
    g_all[lane0 + S:] = 0.0

    def run(x, mu, rho, g, S, **kw):
        x, mu, rho = (t.clone().requires_grad_(True) for t in (x, mu, rho))
        out = kb.sampled_matmul_batched(seed, x, mu, rho, S,
                                        out_dtype=torch.float32, **kw)
        return (out.detach(),) + torch.autograd.grad(out, (x, mu, rho), g)

    before = _launch_counts()
    want = run(x_all, mu_all, rho_all, g_all, S_all)
    got = run(x_all[lanes], mu_all[rows], rho_all[rows],
              g_all[lanes][:, :, rows], S, window=window)
    assert _launch_counts() == before  # CPU tensors: plain versions
    out_w, dx_w, dmu_w, drho_w = want
    for a, b in zip(got, (out_w[lanes][:, :, rows], dx_w[lanes],
                          dmu_w[rows], drho_w[rows])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for a, b in zip(run(x_all, mu_all, rho_all, g_all, S_all,
                        window=(0, N * K, 0)), want):
        assert torch.equal(a, b)

    # the single draw (a shard's rows at lane 0) and the kernels' plain
    # versions with the window
    one = kb.sampled_matmul(seed, x_all[0], mu_all[rows], rho_all[rows],
                            window=(0, N * K, n0 * K))
    torch.testing.assert_close(
        one, kb.sampled_matmul(seed, x_all[0], mu_all, rho_all)[:, rows],
        rtol=1e-6, atol=1e-6)
    sigma = ts.sigma_from_rho(rho_all[rows])
    eps = whole_eps[lanes, rows]
    torch.testing.assert_close(
        kb.sampled_matmul_dx_batched_plain(seed, g_all[lanes][:, :, rows],
                                           mu_all[rows], sigma, window),
        kb.matmul_dx(g_all[lanes][:, :, rows], mu_all[rows], sigma, eps),
        rtol=0, atol=0)
    for a, b in zip(kb.sampled_matmul_dw_batched_plain(
            seed, g_all[lanes][:, :, rows], x_all[lanes], window),
            kb.matmul_dw(g_all[lanes][:, :, rows], x_all[lanes], eps)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not hold"):
        kb.sampled_matmul_batched(seed, x_all[lanes], mu_all[rows],
                                  rho_all[rows], S,
                                  window=(lane0, N * K, N * K))
