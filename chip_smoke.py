"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--profile]

Main path: Bayesian ResNet-50 (reparameterization), eval mode, bf16
compute, ``mc_forward`` with 10 weight draws at batch 128 of 224x224
images, on seeded random weights and images. Phases, each printing its own
line(s):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: the CUDA kernels compiled from ``bayesian_torch_tpu_torch/csrc``;
3. K-A (batch weight sampler) against its plain torch version at the
   ResNet-50 flat size (all Bayesian weights, 10 draws), f32 and bf16 out,
   eps moments, median times;
4. K-B (fused sampled GEMM) against its plain version at the head shape
   (M=128, K=2048, N=1000), f32 with TF32 off, median times;
5. main path: three batches through ``mc_forward(..., num_mc=10,
   reduce="mean")`` (presample "auto", i.e. K-A), one K-A launch per
   batch, predictive entropy, ms per batch and images/s;
6. the head through K-B (``fc.impl = "pallas"``, ``presample="off"``): ten
   K-B launches for one batch; then a sanity run at rho = -30 where ten
   draws must agree with a single draw;
7. with ``--profile`` only: one main-path batch under ``torch.profiler``
   (device time, idle share, the top kernels) and the K-B kernel alone.

The line before the last is a JSON object with every kernel's launches,
counted from zero in the run named by its ``run`` key (K-A: the three
batches of phase 5; K-B: the one batch of phase 6), its error against its
plain version and both times; the last line is ``{"ok": true, "device":
{...}}``, printed only after every phase passed. Any failure raises and
exits non-zero, as does a machine without CUDA.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

BATCH = 128
NUM_MC = 10
IMAGE = 224
SEED = 0
REPS = 5


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def cuda_ms(fn):
    """Milliseconds of one call of ``fn`` on the card (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms_pair(kernel, plain, reps=REPS):
    """Median times of kernel and plain, warmed up, taken in turns."""
    kernel(), plain()
    tk, tp = [], []
    for _ in range(reps):
        tp.append(cuda_ms(plain))
        tk.append(cuda_ms(kernel))
    return statistics.median(tk), statistics.median(tp)


def bf16_ulp(x):
    """One bf16 ulp of |x| (8 significant bits) for normal values."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return name


def phase_build():
    from bayesian_torch_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path, nvcc_s, out = _build.build()
    _build.load_library()
    regs = [ln.strip() for ln in out.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"[build] {path.name}: nvcc {nvcc_s:.1f} s, load "
        f"{time.perf_counter() - t0:.1f} s in all")
    for ln in regs:
        log(f"[build] ptxas: {ln}")


def flat_posterior(model):
    import torch

    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho
    from bayesian_torch_tpu_torch.parallel.mc import _posterior

    pairs = [_posterior(layer) for layer in iter_bayesian_layers(model)]
    with torch.no_grad():
        mu = torch.cat([m.reshape(-1) for m, _ in pairs])
        sigma = torch.cat([sigma_from_rho(r).reshape(-1) for _, r in pairs])
    return mu, sigma


def phase_batch_sampler(model):
    import torch

    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_scaled_normals_batch as ka,
        sample_scaled_normals_batch_plain as ka_plain,
    )

    mu, sigma = flat_posterior(model)
    n = mu.numel()
    seed = 0x5EED_0000_0000_0001
    got = ka(seed, mu, sigma, NUM_MC, torch.float32)
    want = ka_plain(seed, mu, sigma, NUM_MC, torch.float32)
    err32 = (got - want).abs().max().item()
    del got, want
    got = ka(seed, mu, sigma, NUM_MC, torch.bfloat16)
    want = ka_plain(seed, mu, sigma, NUM_MC, torch.bfloat16)
    ulps = ((got.float() - want.float()).abs()
            / bf16_ulp(want)).max().item()
    del got, want
    eps = ka(seed + 1, torch.zeros_like(mu), torch.ones_like(sigma), NUM_MC,
             torch.float32)
    e_mean, e_std = eps.double().mean().item(), eps.double().std().item()
    e_max = eps.abs().max().item()
    del eps
    torch.cuda.synchronize()
    log(f"[K-A] n={n} S={NUM_MC}: f32 max|kernel-plain|={err32:.3e} "
        f"(limit 1e-5); bf16 max diff={ulps:.2f} ulp (limit 1); eps mean "
        f"{e_mean:.2e} std {e_std:.6f} max|eps| {e_max:.3f}")
    check(err32 <= 1e-5, "K-A f32 output differs from its plain version")
    check(ulps <= 1.0, "K-A bf16 output differs by more than one ulp")
    check(abs(e_mean) < 1e-3 and abs(e_std - 1) < 1e-3,
          "K-A eps moments are off")
    ms, plain_ms = median_ms_pair(
        lambda: ka(seed, mu, sigma, NUM_MC, torch.bfloat16),
        lambda: ka_plain(seed, mu, sigma, NUM_MC, torch.bfloat16))
    gbytes = (2 * 4 * n + 2 * NUM_MC * n) / 1e9
    log(f"[K-A] bf16 out, median of {REPS}: kernel {ms:.3f} ms "
        f"({gbytes / ms * 1e3:.0f} GB/s of {gbytes * 1e3:.0f} MB moved), "
        f"plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err32, ms=ms, plain_ms=plain_ms)


def phase_sampled_gemm(model):
    import torch

    from bayesian_torch_tpu_torch.ops.cuda.sampled_matmul import (
        sampled_matmul as kb,
        sampled_matmul_plain as kb_plain,
    )
    from bayesian_torch_tpu_torch.ops.sampling import sigma_from_rho

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mu = model.fc.mu_weight.detach()
    rho = model.fc.rho_weight.detach()
    sigma = sigma_from_rho(rho)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(BATCH, mu.shape[1], generator=gen, device="cuda")
    seed = 4242
    got = kb(seed, x, mu, rho, out_dtype=torch.float32)
    want = kb_plain(seed, x, mu, sigma, torch.float32)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[K-B] M={BATCH} K={mu.shape[1]} N={mu.shape[0]} f32: "
        f"max|kernel-plain|={err:.3e}, limit 1e-4 x max|out| = "
        f"{1e-4 * scale:.3e} (order of summation)")
    check(err <= 1e-4 * scale, "K-B differs from its plain version")
    ms, plain_ms = median_ms_pair(
        lambda: kb(seed, x, mu, rho, out_dtype=torch.float32),
        lambda: kb_plain(seed, x, mu, sigma, torch.float32))
    flops = 2 * BATCH * mu.shape[0] * mu.shape[1]
    log(f"[K-B] median of {REPS}: kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def set_bn_statistics(model, x):
    """Random weights would blow activations up through 50 layers of
    unnormalised eval-mode BN; take the running statistics from one
    training-mode forward of a batch instead."""
    import torch
    from torch import nn

    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: this batch's statistics
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()
    for m in bns:
        m.momentum = 0.1


def images(seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device="cuda")


def entropy(logits):
    p = logits.float().softmax(-1)
    return -(p * p.clamp_min(1e-30).log()).sum(-1).mean().item()


def phase_main_path(model, ka, batches):
    """Three batches through the main path; returns K-A's launches in
    exactly those three calls."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    mc_forward(model, images(SEED + 100), NUM_MC, reduce="mean")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ka.launches = 0
    times = []
    for i, x in enumerate(batches):
        before = ka.launches
        t0 = time.perf_counter()
        out, kl = mc_forward(model, x, NUM_MC, reduce="mean")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(tuple(out.shape) == (BATCH, 1000), f"output shape {out.shape}")
        check(bool(torch.isfinite(out).all()), "non-finite output")
        check(ka.launches - before == 1,
              f"K-A launched {ka.launches - before} times for batch {i}")
        log(f"[main] batch {i}: {times[-1]:.1f} ms, mean predictive "
            f"entropy {entropy(out):.4f} nats (max {math.log(1000):.4f}), "
            f"kl {float(kl):.1f}")
    launches = ka.launches
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[main] ResNet-50 MC-{NUM_MC} bs{BATCH} {IMAGE}^2 bf16: median "
        f"{ms:.1f} ms/batch, {BATCH / ms * 1e3:.1f} images/s "
        f"({BATCH * NUM_MC / ms * 1e3:.1f} image-draws/s), peak "
        f"{peak:.2f} GiB, K-A launches {launches}")
    return launches


def phase_head(model, ka, kb, x):
    """One batch with the head through K-B (draws sampled in the layers);
    returns K-B's launches in that call alone."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    model.fc.impl = "pallas"
    ka.launches = 0
    kb.launches = 0
    try:
        t0 = time.perf_counter()
        out = mc_forward(model, x, NUM_MC, presample="off", reduce="mean",
                         return_kl=False)
        torch.cuda.synchronize()
        head_ms = (time.perf_counter() - t0) * 1e3
    finally:
        model.fc.impl = "xla"
    launches = kb.launches
    check(launches == NUM_MC, f"K-B launched {launches} times, want {NUM_MC}")
    check(tuple(out.shape) == (BATCH, 1000)
          and bool(torch.isfinite(out).all()), "K-B head output")
    log(f"[head] fc.impl='pallas', presample='off': {head_ms:.1f} ms for "
        f"one batch, K-B launches {launches} (and {ka.launches} S=1 K-A "
        f"launches for the in-layer conv draws), entropy {entropy(out):.4f}")
    return launches


def phase_profile(model, x, kb):
    """One main-path batch under torch.profiler: host wall time, device
    time, the device's idle share and the kernels that take it; then the
    K-B kernel alone at the head shape."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bayesian_torch_tpu_torch.parallel import mc_forward

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mc_forward(model, x, NUM_MC, reduce="mean")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = sum(e.self_device_time_total for e in events
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation) / 1e3
    log(f"[profile] one main-path batch: wall {wall:.1f} ms under the "
        f"profiler, device time {dev:.1f} ms, idle share "
        f"{1 - dev / wall:.3f}")
    log(events.table(sort_by="self_cuda_time_total", row_limit=25,
                     max_name_column_width=70))

    mu = model.fc.mu_weight.detach()
    rho = model.fc.rho_weight.detach()
    xk = torch.randn(BATCH, mu.shape[1], device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            kb(4242, xk, mu, rho, out_dtype=torch.float32)
        torch.cuda.synchronize()
    (ev,) = [e for e in prof.key_averages()
             if "sampled_matmul_kernel" in e.key]
    log(f"[profile] K-B kernel alone at M={BATCH} K={mu.shape[1]} "
        f"N={mu.shape[0]}: {ev.self_device_time_total / ev.count / 1e3:.4f} "
        f"ms of device time per launch, {ev.count} launches")


def phase_sanity(model):
    """rho = -30 (sigma ~ 1e-13): every draw equals the posterior mean,
    so the MC-10 mean must agree with one draw."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    rhos = [p for n, p in model.named_parameters() if "rho" in n]
    saved = [p.detach().clone() for p in rhos]
    x = images(SEED + 1)
    with torch.no_grad():
        for p in rhos:
            p.fill_(-30.0)
    try:
        ten = mc_forward(model, x, NUM_MC, reduce="mean", return_kl=False)
        one = mc_forward(model, x, 1, reduce="mean", return_kl=False)
    finally:
        with torch.no_grad():
            for p, v in zip(rhos, saved):
                p.copy_(v)
    diff = (ten - one).abs().max().item()
    scale = one.abs().max().item()
    # both take the same bf16(mu) weights; what differs is the order of
    # the f32 mean: a few bf16 ulps of the largest logit at most
    log(f"[sanity] rho=-30: max|MC-10 mean - single draw| = {diff:.3e}, "
        f"limit 2^-6 x max|logit| = {scale * 2**-6:.3e}")
    check(diff <= scale * 2**-6, "MC mean at sigma ~ 0 differs from a draw")


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one main-path batch and the K-B "
                             "kernel with torch.profiler")
    profile = parser.parse_args(argv).profile
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large \
        import resnet50
    from bayesian_torch_tpu_torch.ops.cuda.sampled_matmul import (
        sampled_matmul,
    )
    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_scaled_normals_batch,
    )

    name = phase_device()
    phase_build()
    torch.manual_seed(SEED)
    model = resnet50(num_classes=1000,
                     generator=torch.Generator().manual_seed(SEED),
                     device="cuda")
    ka_res = phase_batch_sampler(model)
    kb_res = phase_sampled_gemm(model)

    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    set_bn_statistics(model, images(SEED + 200))
    batches = [images(SEED + 1 + i) for i in range(3)]
    ka_launches = phase_main_path(model, sample_scaled_normals_batch,
                                  batches)
    kb_launches = phase_head(model, sample_scaled_normals_batch,
                             sampled_matmul, batches[0])
    phase_sanity(model)
    if profile:
        phase_profile(model, batches[0], sampled_matmul)

    kernels = [
        dict(name="sample_scaled_normals_batch", route="cuda",
             source="bayesian_torch_tpu_torch/csrc/sampled_weights.cu",
             replaces="bayesian_torch_tpu/ops/pallas/sampled_weights.py:126",
             run="main path: mc_forward(num_mc=10, reduce='mean'), "
                 "presample='auto', 3 batches",
             launches=ka_launches, **ka_res),
        dict(name="sampled_matmul", route="cuda",
             source="bayesian_torch_tpu_torch/csrc/sampled_matmul.cu",
             replaces="bayesian_torch_tpu/ops/pallas/sampled_matmul.py:62",
             run="head: fc.impl='pallas', mc_forward(num_mc=10, "
                 "presample='off'), 1 batch",
             launches=kb_launches, **kb_res),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never ran in {k['run']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
