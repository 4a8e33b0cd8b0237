"""The split-TF32 product of the fused sampled GEMM kernels (K-B and K-D,
``bayesian_torch_tpu_torch/csrc/sampled_gemm.cuh``), emulated in torch on
the CPU: why three TF32 products and not one keep the port's gate of
1e-4 x max|plain| at the ResNet-50 head, and the split's exactness."""

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


def test_three_tf32_products_keep_the_gate_and_one_does_not():
    x, w = _head()
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
