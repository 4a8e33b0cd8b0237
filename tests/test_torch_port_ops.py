"""Port ops against the JAX package: the counter-hash generator, sigma /
log-sigma / KL, and the algebra of both kernels (batch sampler K-A and
fused sampled GEMM K-B) against the Pallas kernels run in interpret mode.
Inputs come from numpy with fixed seeds; tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_torch_tpu.ops import kl as jkl
from bayesian_torch_tpu.ops import sampling as js
from bayesian_torch_tpu.ops.pallas.sampled_matmul import sampled_matmul_pallas
from bayesian_torch_tpu.ops.pallas.sampled_weights import (
    sample_scaled_normals_batch as jax_batch_sampler,
)
from bayesian_torch_tpu_torch.ops import kl as tkl
from bayesian_torch_tpu_torch.ops import sampling as ts
from bayesian_torch_tpu_torch.ops.cuda import _build
from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from tests import _torch_port  # noqa: F401  (one torch thread per worker)

# ---------------------------------------------------------------- generator


@pytest.mark.parametrize("key_seed,shape", [(0, (1000,)), (7, (64, 37)),
                                            (123456, (3, 5, 7, 11))])
def test_normal_fused_matches_jax(key_seed, shape):
    key = jax.random.key(key_seed)
    salt = int(js._key_salt(key))
    want = np.asarray(js.normal_fused(key, shape))
    got = ts.normal_fused(salt, shape).numpy()
    # same integers; log/cos of two libraries differ in the last ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_normal_fused_cpu_chunks_join_seamlessly():
    """The CPU path runs in cache-sized chunks: values must not depend on
    the chunk boundaries (position 2**16 straddles one)."""
    n = ts._CPU_CHUNK + 10
    whole = ts._normals(99, 0, n, "cpu")
    np.testing.assert_array_equal(ts.normal_fused(99, (n,)).numpy(),
                                  whole.numpy())


def test_rademacher_fused_bit_identical():
    key = jax.random.key(11)
    salt = int(js._key_salt(key))
    want = np.asarray(js.rademacher_fused(key, (4, 999)))
    got = ts.rademacher_fused(salt, (4, 999)).numpy()
    np.testing.assert_array_equal(got, want)


def test_normal_fused_moments():
    z = ts.normal_fused(ts.draw_salt(2024, 0, 10**6), (10**6,)).double()
    assert abs(z.mean().item()) < 5e-3
    assert abs(z.std().item() - 1.0) < 5e-3


def test_draws_differ_across_s_and_seeds():
    n = 4096
    mu, sigma = torch.zeros(n), torch.ones(n)
    w = ka.sample_scaled_normals_batch(5, mu, sigma, 3, torch.float32)
    for a in range(3):
        for b in range(a + 1, 3):
            assert abs(np.corrcoef(w[a].numpy(), w[b].numpy())[0, 1]) < 0.1
    other = ka.sample_scaled_normals_batch(6, mu, sigma, 1, torch.float32)
    assert not torch.equal(other[0], w[0])
    salts = {ts.draw_salt(seed, s, n) for seed in (0, 1, 2**63 - 1)
             for s in range(10)}
    assert len(salts) == 30 and all(0 <= v < 2**32 for v in salts)


_GOLDEN_INV = pow(ts._SM32_GOLDEN, -1, 2**32)


def test_salts_golden_steps_apart_share_a_shifted_stream():
    """The overlap that independent per-draw salts risk: two salts k
    GOLDEN steps apart hash the same counters shifted by k, so two draws
    of n counters each share a stretch of eps whenever their salts lie
    fewer than n steps apart."""
    a = ts._seed_salt(7, 0)  # draw 0's salt, as before and after
    for k in (1, 1000, 2**31 + 5):
        b = (a + k * ts._SM32_GOLDEN) & ts._M32
        assert (b - a) * _GOLDEN_INV % 2**32 == k
        torch.testing.assert_close(ts._hashes(b, 0, 4096, "cpu"),
                                   ts._hashes(a, k, 4096, "cpu"),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 2**40 + 17, 2**63 - 1])
def test_lanes_of_one_launch_read_disjoint_windows_of_one_stream(seed):
    """Lane s of a launch over n counters takes the salt of lane 0
    advanced by s*n counters: its hashes are the window [s*n, (s+1)*n) of
    lane 0's stream, lane 0 keeps the single draw's salt, and the batch
    sampler's lanes are those windows. normal_fused under a lane's salt
    is still the JAX normal_fused under a key with that salt."""
    n, S = 1000, 4
    stream = ts._hashes(ts.draw_salt(seed, 0, n), 0, S * n, "cpu")
    for s in range(S):
        torch.testing.assert_close(
            ts._hashes(ts.draw_salt(seed, s, n), 0, n, "cpu"),
            stream[s * n:(s + 1) * n], rtol=0, atol=0)
    assert ts.draw_salt(seed, 0, n) == ts.draw_salt(seed, 0, 7) \
        == ts._seed_salt(seed, 0)
    w = ka.sample_scaled_normals_batch_plain(
        seed, torch.zeros(n), torch.ones(n), S, torch.float32)
    for s in range(S):
        torch.testing.assert_close(
            w[s], ts.normal_fused(ts.draw_salt(seed, s, n), (n,)),
            rtol=0, atol=0)
    salt = ts.draw_salt(seed, 3, n)
    key = jax.random.wrap_key_data(jnp.asarray([salt, 0], jnp.uint32))
    assert int(js._key_salt(key)) == salt
    np.testing.assert_allclose(ts.normal_fused(salt, (n,)).numpy(),
                               np.asarray(js.normal_fused(key, (n,))),
                               rtol=0, atol=1e-6)
    ts.check_counters(S, 2**32 // S - 1)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        ts.check_counters(S, 2**32 // S)


def test_windows_of_two_launches_overlap_at_the_rate_of_their_lengths():
    """Two launches under independent seeds (two layers' draws) share a
    stretch of eps when lane 0's salts lie fewer than n1 (or n2) GOLDEN
    steps apart: measured over 100,000 seed pairs at n1 = n2 = 2**24,
    the rate is (n1 + n2 - 1) / 2**32 within five standard errors."""
    rs = np.random.RandomState(0)
    n, pairs = 2**24, 100_000
    seeds = rs.randint(0, 2**62, size=(pairs, 2), dtype=np.int64)
    hits = 0
    for a, b in seeds.tolist():
        k = (ts.draw_salt(b, 0, n) - ts.draw_salt(a, 0, n)) \
            * _GOLDEN_INV % 2**32
        hits += k < n or k > 2**32 - n
    rate, want = hits / pairs, (2 * n - 1) / 2**32
    print(f"overlap rate of two windows of 2**24 counters: {rate:.5f} "
          f"over {pairs} seed pairs; (n1 + n2 - 1) / 2**32 = {want:.5f}")
    assert abs(rate - want) <= 5 * (want * (1 - want) / pairs) ** 0.5


def test_draw_seed_follows_generator():
    a = ts.draw_seed(torch.Generator().manual_seed(3))
    b = ts.draw_seed(torch.Generator().manual_seed(3))
    c = ts.draw_seed(torch.Generator().manual_seed(4))
    assert a == b != c and 0 <= a < 2**63


# ---------------------------------------------------------- sigma and KL

RHO = np.concatenate([np.linspace(-30, 5, 701), [-20.0, -20.5, -19.99]]
                     ).astype(np.float32)


def test_sigma_and_log_sigma_match_jax():
    rho = torch.from_numpy(RHO)
    np.testing.assert_allclose(ts.sigma_from_rho(rho).numpy(),
                               np.asarray(js.sigma_from_rho(RHO)),
                               rtol=1e-6, atol=0)
    # includes the rho < -20 asymptote branch
    np.testing.assert_allclose(ts.log_sigma_from_rho(rho).numpy(),
                               np.asarray(js.log_sigma_from_rho(RHO)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("moped", [False, True])
def test_kl_matches_jax(moped):
    rs = np.random.RandomState(0)
    mu_q = rs.normal(0, 0.3, RHO.shape).astype(np.float32)
    if moped:  # array priors, as MOPED sets them
        mu_p = rs.normal(0, 0.1, RHO.shape).astype(np.float32)
        sigma_p = rs.uniform(0.05, 1.0, RHO.shape).astype(np.float32)
    else:
        mu_p, sigma_p = 0.0, 1.0
    want = float(jkl.gaussian_kl_from_rho(mu_q, RHO, mu_p, sigma_p))
    got = float(tkl.gaussian_kl_from_rho(
        torch.from_numpy(mu_q), torch.from_numpy(RHO),
        torch.as_tensor(mu_p), torch.as_tensor(sigma_p)))
    assert got == pytest.approx(want, rel=1e-6)
    sq = np.log1p(np.exp(RHO[RHO > -20]))
    want = float(jkl.gaussian_kl(mu_q[RHO > -20], sq, 0.0, 1.0))
    got = float(tkl.gaussian_kl(torch.from_numpy(mu_q[RHO > -20]),
                                torch.from_numpy(sq), 0.0, 1.0))
    assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------ K-A: the batch sampler


def test_batch_sampler_algebra_matches_jax_kernel():
    """Interpret mode gives the Pallas kernel constant bits, so take its
    implied eps = (w - mu) / sigma and feed it to the port's algebra."""
    rs = np.random.RandomState(1)
    n, S = 3000, 3
    mu = rs.normal(0, 0.3, n).astype(np.float32)
    sigma = rs.uniform(0.01, 0.2, n).astype(np.float32)
    w = np.asarray(jax_batch_sampler(jax.random.key(0), mu, sigma, S,
                                     jnp.float32))
    eps = (w - mu) / sigma
    got = ka.scale_shift(torch.from_numpy(mu), torch.from_numpy(sigma),
                         torch.from_numpy(eps), torch.float32)
    # eps recovered by a division: rounding of one f32 op on w
    np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-6)


def test_batch_sampler_plain_is_normal_fused_per_draw():
    rs = np.random.RandomState(2)
    mu = torch.from_numpy(rs.normal(0, 0.3, (7, 5, 3)).astype(np.float32))
    sigma = torch.from_numpy(rs.uniform(0.01, 0.2, (7, 5, 3))
                             .astype(np.float32))
    seed = 2**40 + 17
    launches = ka.sample_scaled_normals_batch.launches
    w = ka.sample_scaled_normals_batch(seed, mu, sigma, 4, torch.float32)
    assert w.shape == (4, 7, 5, 3)
    assert ka.sample_scaled_normals_batch.launches == launches  # CPU: plain
    for s in range(4):
        eps = ts.normal_fused(ts.draw_salt(seed, s, mu.numel()), mu.shape)
        torch.testing.assert_close(w[s], mu + sigma * eps, rtol=0, atol=0)
    wb = ka.sample_scaled_normals_batch(seed, mu, sigma, 4)
    assert wb.dtype == torch.bfloat16
    torch.testing.assert_close(wb, w.to(torch.bfloat16), rtol=0, atol=0)
    rho = torch.log(torch.expm1(sigma))
    torch.testing.assert_close(
        ka.sample_gaussian_batch(seed, mu, rho, 4, torch.float32), w,
        rtol=1e-6, atol=1e-6)


def test_batch_sampler_plain_differentiable_on_cpu():
    mu = torch.zeros(10, requires_grad=True)
    sigma = torch.full((10,), 0.5, requires_grad=True)
    w = ka.sample_scaled_normals_batch(1, mu, sigma, 3, torch.float32)
    (w ** 2).sum().backward()
    eps = (w.detach() - 0.0) / 0.5
    torch.testing.assert_close(mu.grad, 2 * w.detach().sum(0))
    torch.testing.assert_close(sigma.grad, (2 * w.detach() * eps).sum(0))


def test_single_draw_algebra_and_grads_match_jax():
    """The single draw on injected eps: the port's algebra (sigma =
    softplus(rho), mu + sigma * eps as K-A rounds it) and its gradients
    (autograd, and K-C rho mode's g * eps * sigmoid(rho)) against the JAX
    package's mu + softplus(rho) * eps and its VJP. The TPU kernel's bits
    come from the chip's PRNG, so only the algebra is compared; rho above
    softplus's threshold of 20 and far below zero included."""
    rs = np.random.RandomState(4)
    n = 5000
    mu = rs.normal(0.0, 0.3, n).astype(np.float32)
    rho = rs.normal(-4.0, 2.0, n).astype(np.float32)
    rho[:3] = [25.0, -40.0, 20.0]
    eps = rs.standard_normal(n).astype(np.float32)
    g = rs.standard_normal(n).astype(np.float32)
    w_jax, vjp = jax.vjp(lambda m, r: m + jax.nn.softplus(r) * eps,
                         jnp.asarray(mu), jnp.asarray(rho))
    dmu_jax, drho_jax = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tmu = torch.from_numpy(mu).requires_grad_(True)
    trho = torch.from_numpy(rho).requires_grad_(True)
    w = ka.scale_shift(tmu, ts.sigma_from_rho(trho),
                       torch.from_numpy(eps)[None], torch.float32)[0]
    dmu, drho = torch.autograd.grad(w, (tmu, trho), torch.from_numpy(g))
    drho_kc = ka.drho_from_noise(torch.from_numpy(g), torch.from_numpy(eps),
                                 torch.from_numpy(rho))
    # softplus and sigmoid of two libraries: the last ulp of sigma and of
    # the gradient
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_jax),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(dmu.numpy(), dmu_jax)
    for got in (drho, drho_kc):
        np.testing.assert_allclose(got.numpy(), drho_jax, rtol=1e-5,
                                   atol=1e-6)


def test_batch_sampler_rejects_bad_input():
    mu = torch.zeros(4)
    with pytest.raises(ValueError):
        ka.sample_scaled_normals_batch(0, mu, torch.zeros(5), 2)
    with pytest.raises(ValueError):
        ka.sample_scaled_normals_batch(0, mu, mu, 2, torch.float16)
    with pytest.raises(ValueError):
        ka.sample_scaled_normals_batch(0, mu, mu, 0)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):  # neither the CPU nor one CUDA device
        ka.sample_scaled_normals_batch(0, meta, meta, 2)


# --------------------------------------------- K-B: the fused sampled GEMM


def _kb_setup(K=70, N=50, M=30, seed=0):
    rs = np.random.RandomState(seed)
    mu = rs.randn(N, K).astype(np.float32) * 0.3
    rho = rs.randn(N, K).astype(np.float32) - 2.0
    x = rs.randn(M, K).astype(np.float32)
    return x, mu, rho


def test_sampled_matmul_algebra_matches_jax_kernel():
    """The Pallas kernel's implied weight (identity probe) gives its eps;
    the port's algebra on that eps reproduces the kernel's output."""
    x, mu, rho = _kb_setup()
    key = jax.random.key(5)
    K = mu.shape[1]
    W = np.asarray(sampled_matmul_pallas(key, jnp.eye(K), mu, rho,
                                         out_dtype=jnp.float32)).T
    sigma = np.log1p(np.exp(rho))
    eps = (W - mu) / sigma
    want = np.asarray(sampled_matmul_pallas(key, x, mu, rho,
                                            out_dtype=jnp.float32))
    got = kb.matmul_sampled_weight(torch.from_numpy(x), torch.from_numpy(mu),
                                   torch.from_numpy(sigma),
                                   torch.from_numpy(eps))
    # f32 sums of 70 products in two orders, eps recovered by a division
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_sampled_matmul_plain_weight_is_one_batch_draw():
    """eps depends on (seed, n, k) only: the plain GEMM's weight is the
    batch sampler's single draw of the same (N, K) posterior."""
    x, mu, rho = (torch.from_numpy(a) for a in _kb_setup(seed=3))
    seed = 1234567
    launches = kb.sampled_matmul.launches
    got = kb.sampled_matmul(seed, x, mu, rho)
    assert kb.sampled_matmul.launches == launches  # CPU: plain
    w = ka.sample_scaled_normals_batch(seed, mu, ts.sigma_from_rho(rho), 1,
                                       torch.float32)[0]
    torch.testing.assert_close(got, x @ w.T, rtol=1e-6, atol=1e-5)
    assert got.dtype == torch.float32
    half = kb.sampled_matmul(seed, x.to(torch.bfloat16), mu, rho)
    assert half.dtype == torch.bfloat16


def test_sampled_matmul_rejects_bad_shapes():
    x, mu, rho = (torch.from_numpy(a) for a in _kb_setup())
    with pytest.raises(ValueError):
        kb.sampled_matmul(0, x[:, :-1], mu, rho)
    with pytest.raises(ValueError):
        kb.sampled_matmul(0, x, mu, rho[:, :-1])


def test_kernel_build_is_lazy_and_content_named():
    """Importing the kernel modules builds nothing; the library is named
    by a hash of the CUDA sources."""
    a = _build.library_path()
    assert a == _build.library_path()
    assert a.parent == _build.BUILD_DIR and a.suffix == ".so"
    assert {p.name for p in _build._sources()} == {
        "flipout_signs.cu", "mc_gemm.cu", "qmatmul.cu", "sampled_matmul.cu",
        "sampled_matmul_bwd.cu", "sampled_weights.cu",
        "sampled_weights_bwd.cu"}
    assert _build.load_library.cache_info().currsize == 0
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_port_never_imports_jax():
    """No module of the port, ``examples/`` included, nor the card's
    scripts ``chip_smoke.py`` and ``kernel_times.py``, imports jax or the
    JAX package: none names jax, and importing them all with jax made
    unimportable works (an indirect import, e.g. through
    ``bayesian_torch_tpu.data``, would fail) and leaves
    ``bayesian_torch_tpu`` unimported."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(ts.__file__).resolve().parents[1]
    # _build/ holds build outputs (git-ignored), no module of the port
    paths = sorted(p for p in root.rglob("*.py")
                   if "_build" not in p.relative_to(root).parts)
    for new in ("examples/main_bayesian_imagenet.py",
                "examples/main_bayesian_flipout_imagenet.py",
                "ops/cuda/mc_gemm.py",
                "layers/flipout_layers/conv_flipout.py",
                "layers/flipout_layers/linear_flipout.py",
                "models/bayesian/resnet_flipout_large.py",
                "models/deterministic/resnet_large.py",
                "models/dnn_to_bnn.py", "utils/util.py",
                "utils/avuc_loss.py", "utils/uncertainty_calibration_loss.py",
                "examples/main_deterministic_imagenet.py",
                "examples/main_bayesian_imagenet_dnn2bnn.py",
                "examples/main_bayesian_imagenet_bnn2qbnn.py",
                "graft_entry.py",
                "models/_scnn.py", "models/_cifar_resnet.py",
                "models/bayesian/simple_cnn_variational.py",
                "models/bayesian/resnet_variational.py",
                "models/bayesian/resnet_flipout.py",
                "models/flipout/__init__.py", "models/flipout/simple_cnn.py",
                "models/flipout/resnet.py",
                "models/deterministic/simple_cnn.py",
                "models/deterministic/resnet.py",
                "examples/main_deterministic_mnist.py",
                "examples/main_bayesian_mnist.py",
                "examples/main_deterministic_cifar.py",
                "examples/main_bayesian_cifar.py",
                "examples/main_bayesian_flipout_cifar.py",
                "examples/main_bayesian_cifar_dnn2bnn.py",
                "examples/quantization_test.py",
                "layers/flipout_layers/quantized_conv_flipout.py",
                "layers/flipout_layers/quantized_linear_flipout.py",
                "models/bayesian/quantized_resnet_flipout_large.py",
                "ao/nn/__init__.py", "ao/nn/quantized/__init__.py",
                "ao/nn/quantized/modules/__init__.py",
                "ao/nn/quantized/modules/quantize_conv_variational.py",
                "ao/nn/quantized/modules/quantize_linear_variational.py",
                "ao/nn/quantized/modules/quantized_conv_flipout.py",
                "ao/nn/quantized/modules/quantized_linear_flipout.py",
                "layers/rnn_base.py",
                "layers/variational_layers/rnn_variational.py",
                "layers/flipout_layers/rnn_flipout.py",
                "examples/main_bayesian_lstm_timeseries.py",
                "ops/remat.py", "utils/profiling.py",
                "parallel/mesh.py", "parallel/distributed.py",
                "parallel/tp.py", "parallel/_comm.py", "data/__init__.py",
                "data/loader.py"):
        assert root / new in paths, new
    paths += [root.parent / "chip_smoke.py", root.parent / "kernel_times.py"]
    modules = []
    for path in paths:
        for line in path.read_text().splitlines():
            code = line.split("#")[0]
            assert not code.lstrip().startswith(("import jax", "from jax")), \
                f"{path}: {line}"
        rel = path.relative_to(root.parent).with_suffix("")
        modules.append(".".join(rel.parts[:-1] if rel.name == "__init__"
                                else rel.parts))
    probe = ("import importlib, sys\n"
             "sys.modules['jax'] = None\n"
             f"for name in {modules!r}:\n"
             "    importlib.import_module(name)\n"
             "assert not any(m == 'jax' or m.startswith('jax.')\n"
             "               for m in sys.modules if sys.modules[m])\n"
             "assert 'bayesian_torch_tpu' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=root.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
