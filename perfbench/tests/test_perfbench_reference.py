"""The yardstick against what it stands for: the plain reference against
the port's CPU path on a narrow ResNet from the same seeds, its frozen
noise against the port's generator, the operation count against
torchvision's published figure, and the bounds against the kernel
table's."""

from __future__ import annotations

import json
import math
import time

import pytest
import torch

from perfbench import arch as arch_mod, flops, roofline, run, spec
from perfbench.reference import noise
from perfbench.tests import narrow

RESNET50 = json.loads((narrow.REPO / "perfbench/configs/"
                       "bayesian_resnet50.json").read_text())


def test_flops_match_torchvision():
    # torchvision's resnet50: 4.09 G multiply-adds an image at 224^2
    macs = flops.macs_per_image(arch_mod.resnet(RESNET50))
    assert abs(macs / 4.09e9 - 1) < 0.02
    assert len(arch_mod.resnet(RESNET50).layers) == 54
    flip = dict(RESNET50, estimator="Flipout")
    a = arch_mod.resnet(RESNET50)
    assert flops.per_unit(a, flip, "predict", 2, 3) == \
        2 * flops.per_unit(a, RESNET50, "predict", 2, 3)
    assert flops.per_unit(a, RESNET50, "train", 2, 3) == \
        3 * flops.per_unit(a, RESNET50, "predict", 2, 3)


def test_parameter_count():
    a = arch_mod.resnet(RESNET50)
    n = sum(l.weight_numel + (l.cout if l.bias else 0) for l in a.layers)
    assert n + 2 * sum(a.bn_channels.values()) == 25_557_032


def test_bounds_match_the_kernel_table():
    a = arch_mod.resnet(RESNET50)
    n = sum(l.weight_numel + (l.cout if l.bias else 0) for l in a.layers)
    # K-A's flat bf16 call: mu, rho and one draw in bf16 (0.046 ms)
    assert round(roofline.sampler_bound_ms(n, 1, 2, 2), 3) == 0.046
    # K-H1's 540 flips of an MC-10 bs128 batch (16.30 ms)
    flips = sum(roofline.flip_bound_ms(l.in_elems(128)) for l in a.layers)
    assert round(10 * flips, 2) == 16.30
    cfg = dict(RESNET50, estimator="Flipout")
    combines = sum(roofline.combine_bound_ms(l.out_elems(128))
                   for l in a.layers)
    assert math.isclose(roofline.signs_ms(a, cfg, "predict", 10, 128),
                        10 * (flips + combines))
    # K-H2's 540 combines (25.48 ms)
    assert round(10 * combines, 2) == 25.48


def test_frozen_noise_is_the_ports():
    from bayesian_torch_tpu_torch.ops import sampling

    seed = 2**40 + 77
    for s, n, start in ((0, 1000, 0), (3, 4097, 123)):
        salt = noise.draw_salt(seed, s, n)
        assert salt == sampling.draw_salt(seed, s, n)
        got = noise.normals(salt, start, n, "cpu")
        want = sampling.normal_fused(salt, (n,), start=start)
        assert torch.allclose(got, want, rtol=0, atol=2e-6)
    assert noise.sign_salts(seed, 4) == sampling.sign_salts(seed, 4)
    salt = noise.seed_salt(seed, 1)
    assert torch.equal(noise.signs(salt, (3, 5, 7), "cpu"),
                       sampling.rademacher_fused(salt, (3, 5, 7)))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator()
    g2.manual_seed(5)
    assert noise.draw_seed(g1) == sampling.draw_seed(g2)


def _run(tmp_path, estimator, traffic, limits, seed):
    root = narrow.checkout(tmp_path, {"narrow": (
        narrow.config(estimator, "float32"), traffic, limits, 1)})
    return run.run(spec.Cell("narrow", root), seed, 0.1, False,
                   torch.device("cpu"), time.time())


@pytest.mark.parametrize("estimator", ["Reparameterization", "Flipout"])
def test_reference_predicts_as_the_port(tmp_path, estimator):
    """The port's MC-3 mean on the CPU in float32 and the reference's
    agree to rounding: the same draws, signs, seeds and layers."""
    res = _run(tmp_path, estimator,
               {"mode": "predict", "num_mc": 3, "batch": 2, "ring": 3,
                "warmup": 1, "traced": 1, "checked": 2},
               {"mean_gap": 1e-5, "kl_gap": 1e-6}, 2**31 + 5)
    assert res["correct"], res["checks"]


def test_reference_trains_as_the_port(tmp_path):
    """The port's first ELBO steps on the CPU in float32 and the
    reference's: the loss, step 1's gradient and the running statistics
    to rounding; the change after three steps within what BatchNorm over
    a 2x2 final stage lets rounding grow to."""
    res = _run(tmp_path, "Reparameterization",
               {"mode": "train", "num_mc": 2, "batch": 8, "ring": 4,
                "check_steps": 3, "traced": 1, "lr": 0.01,
                "momentum": 0.9},
               {"loss_gap": 1e-3, "grad_gap": 1e-4, "change_gap": 0.05,
                "running_gap": 1e-4}, 7)
    assert res["correct"], res["checks"]
