"""The split-TF32 product of the fused sampled GEMM kernels (K-B and K-D,
``bayesian_torch_tpu_torch/csrc/sampled_gemm.cuh``; K-E's weight gradient,
``csrc/sampled_matmul_bwd.cu``), emulated in torch on the CPU: why three
TF32 products and not one keep the port's gate of 1e-4 x max|plain| at the
ResNet-50 head, that K-E's lane sums of them keep it too, and the split's
exactness."""

import numpy as np
import pytest
import torch

from tests._torch_port import split_tf32, tf32, tf32_matmul

# the head: x (M, K) @ W^T, W (N, K) = mu + sigma * eps with mu ~ N(0, 0.1^2)
# and sigma * eps ~ N(0, 0.0486^2) (softplus(-3) = 0.0486)
M, K, N = 128, 2048, 1000


def _head(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((M, K)).astype(np.float32)
    w = (rs.normal(0.0, 0.1, (N, K))
         + rs.normal(0.0, 0.0486, (N, K))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _dw_operands(seed=0, lanes=1):
    """K-E's product at the head, g^T x, as tf32_matmul's (a, b): a = g^T
    (N, M), b = x^T (K, M), per lane; g ~ N(0, 1e-3^2) (the head's output
    gradient, cross-entropy over 1000 classes), x ~ N(0, 1)."""
    rs = np.random.RandomState(seed)
    g = rs.normal(0.0, 1e-3, (lanes, M, N)).astype(np.float32)
    x = rs.standard_normal((lanes, M, K)).astype(np.float32)
    return (torch.from_numpy(g).transpose(1, 2),
            torch.from_numpy(x).transpose(1, 2))


def _ke_head():
    a, b = _dw_operands()
    return a[0], b[0]


@pytest.mark.parametrize("operands", [_head, _ke_head],
                         ids=["K-B", "K-E"])
def test_three_tf32_products_keep_the_gate_and_one_does_not(operands):
    x, w = operands()
    ref = x.double() @ w.double().T
    scale = ref.abs().max().item()
    err3 = (tf32_matmul(x, w, terms=3) - ref).abs().max().item() / scale
    err1 = (tf32_matmul(x, w, terms=1) - ref).abs().max().item() / scale
    # an f32 sgemm is about 4e-7 here; the split form keeps 1e-5 of it with
    # room, a single TF32 product (10 mantissa bits) misses the 1e-4 gate
    assert err3 <= 1e-5, err3
    assert err1 > 1e-4, err1


@pytest.mark.parametrize("seed", [0, 1])
def test_split_is_exact_to_twenty_bits(seed):
    """hi and lo are TF32 values (13 low bits clear), hi + lo is a within
    2^-20 of |a|, and hi is a's leading part."""
    rs = np.random.RandomState(seed)
    a = torch.from_numpy(
        (rs.standard_normal(4096) * 10.0 ** rs.uniform(-6, 6, 4096))
        .astype(np.float32))
    hi, lo = split_tf32(a)
    for t in (hi, lo):
        assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(hi, tf32(a))
    assert bool((hi.abs() <= a.abs()).all())
    rest = (a.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -20 * a.double().abs()).all())


def test_lane_sums_of_three_tf32_products_keep_the_gate():
    """K-E at S = 4: dmu = sum_s g_s^T x_s and dsigma = sum_s (g_s^T x_s) *
    eps_s, each lane's product in three TF32 terms and the sums in f32 in
    lane order as the kernel adds them, within 1e-5 of max|plain| (the
    exact sums in f64)."""
    a, b = _dw_operands(seed=3, lanes=4)
    eps = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (4, N, K)).astype(np.float32))
    dmu = dsig = None
    for s in range(4):
        d = tf32_matmul(a[s], b[s], terms=3).float()
        de = d * eps[s]
        dmu = d if dmu is None else dmu + d
        dsig = de if dsig is None else dsig + de
    exact = [a[s].double() @ b[s].double().T for s in range(4)]
    ref_mu = sum(exact)
    ref_sig = sum(e * eps[s].double() for s, e in enumerate(exact))
    for got, ref in ((dmu, ref_mu), (dsig, ref_sig)):
        err = (got.double() - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err


def test_bf16_x_splits_exactly():
    """x rounded to bf16 (the draw loop's head input) is a TF32 value: its
    hi part is x and its lo part 0, so K-E skips the product with the lo
    part and keeps the gate."""
    a, b = _dw_operands(seed=5)
    x = b[0].to(torch.bfloat16).float()
    hi, lo = split_tf32(x)
    assert torch.equal(hi, x)
    assert bool((lo == 0).all())
    ref = a[0].double() @ x.double().T
    err = (tf32_matmul(a[0], x, terms=3) - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err
