"""Device times of the hand-written kernels at Bayesian ResNet-50's shapes:
the weight sampler K-A and its backward K-C, the GEMMs K-B, K-D, K-E, K-G
and K-F beside one PyTorch call for the same product where there is one,
the Flipout sign kernels K-H; and the device busy time of the training
and inference paths that run them.

    python3 kernel_times.py [--label NAME] [--sections NAME ...]

Runs the sections below in turn (all, or those named). Imports ``bayesian_torch_tpu_torch``
from the current directory, so the same script times two checkouts (a
change and its parent, each unpacked with ``git archive``) in turns on one
card. Kernel times are the kernel's own device time per launch from
``torch.profiler`` over ``REPS`` back-to-back launches after a warm-up
(the wrapper's small torch ops, such as K-F's column sums, are not
counted); a library call counts all its device rows. Needs a CUDA card;
prints one line per shape and a JSON summary last.

- ``sampler``: K-A and K-C (``ops/cuda/sampled_weights.py``), each
  mode as one launch over the flat 25.5 M weights and as a training
  step's own launches over the 54 per-layer buffers of
  ``iter_bayesian_layers(resnet50())`` in model order (53 conv weights and
  the head's bias), back to back, summed: K-A at S = 10 (the inference
  presample, flat only), K-A in rho mode at S = 1 and K-C drho, four times
  over for the loop MC-4 step (216 launches; bf16 mu, rho and g, as the
  draw loop gives them), K-A at S = 4 (f32 mu and sigma) and K-C dsigma
  (bf16 g) once for the vmap MC-4 step (54); K-A rho and K-C drho also
  flat with f32 operands. Each row's bound is the larger of bytes and the
  generation of its normals. With
  ``sampled`` also run, the summary ranks K-A's per-layer modes, K-C and
  K-E by launches x (device time - bound) over three loop and three vmap
  MC-4 steps.
- ``sampled``: the fused sampled GEMM and its backward
  (``ops/cuda/sampled_matmul.py``) at the head (M = 128, K = 2048,
  N = 1000, f32, TF32 off): K-B at S = 1 and with lanes at S = 4 and 10 (x
  per lane and shared), K-D at S = 1 and 4, K-E at S = 1 and 4; beside the
  unfused route (all its device rows): K-A drawing the S weights in f32
  and then ``torch.matmul``; for K-E, ``torch.matmul`` over the S*M rows
  for dmu, K-A drawing the S eps windows (mu 0, sigma 1), ``torch.bmm``
  per lane and a sum over the lanes for dsigma. No PyTorch call samples
  the weight inside a GEMM. Each row's bound is the largest of bytes,
  operations (three TF32 products on the tensor cores) and the generation
  of its normals (``generation_ms``).
- ``windowed``: K-B, K-D and K-E at the head under the counter windows
  of the mesh paths, each beside the whole launch of the same size (the
  same lanes, rows and operands, no window), in turns in one profiler
  session: a rank's lanes (K-B lanes 5-9 of an MC-10 launch, K-D and K-E
  lanes 2-3 of an MC-4 launch) and a 'model' shard's rows 500-999 (K-B at
  S = 1 and 2, K-D and K-E at S = 1). The window changes the salt and the
  counter base alone, so the two should take the same time.
- ``paths``: ResNet-50 (bf16) with the head on K-B and K-D
  (``fc.impl = "pallas"``): through the draw loop, MC-10 bs128 inference
  with ``presample="off"`` (``chip_smoke.py``'s phase 6) and the MC-4
  bs128 ELBO step with ``emission="scan"`` (phase 8); the MC-4 bs128 ELBO
  step with ``emission="vmap"``. Host wall ms of each batch or step
  without the profiler, then three of each under the profiler: device busy
  ms (the union of the device rows' spans), idle share, and the K-A, K-B,
  K-C, K-D, K-E rows' device ms.
- ``kg``: K-G (``ops/cuda/mc_gemm.py``), bf16, at the 12 pointwise sites
  of ResNet-50 (MC-10, batch 128): ``mc_gemm`` per draw,
  ``pointwise_gemm`` with one weight over the B*S batch (the Flipout mean
  convs), and the input gradient ``mc_gemm(g, w^T)``; beside
  ``torch.matmul`` with the broadcast weight and the S-way grouped cuDNN
  conv. ``probe``: ``matmul`` at 4096^3 and 8192 x 4096 x 4096, bf16 and
  int8.
- ``kg_cl``: K-G channels-last (``mc_gemm_cl``), bf16, at the same 12
  sites in the (M, S, C) layout of an NHWC draw-axis activation (M =
  B*H*W): the forward, ``pointwise_gemm_cl`` with one weight over the M*S
  rows and dx (the kernel on the transposed weight), each beside
  ``torch.einsum`` on the same operands; the bound counts x, w and y once.
- ``nhwc``: ResNet-50 NHWC (bf16) with ``CONV_1X1_DOT``: the vmap MC-10
  bs128 batch and the vmap MC-4 bs128 ELBO step, host wall ms (median of
  5) and two profiled runs each (device busy ms, idle share, K-G
  channels-last's device ms).
- ``kf``: K-F (``ops/cuda/qmatmul.py``) at the 21 GEMM shapes of one INT8
  ``qresnet50`` forward at batch 128 (54 launches; the stem's K of 147
  widened to 160 as ``ops.int8.qconv`` does), beside ``torch._int_mm``.
- ``signs``: K-H (``ops/cuda/flipout_signs.py``) over the sign work of one
  Flipout MC-10 bs128 batch through the draw loop at ResNet-50's 54
  layers (``sign_work``: 540 flips of the layers' inputs, 540 combines of
  their outputs in bf16, 1,080 INT8 sign products on uint8 and, in a
  checkout with it, K-H3's 540 requantizing input passes), each kernel's
  device time beside its plain version's and its bound (bytes, or the
  hash's instructions at the issue rate); in a checkout without K-H, the
  route it replaced (the hash in torch, then the product).
- ``flipout``: the paths K-H serves, in any checkout: Flipout ResNet-50
  bf16 MC-10 bs128 through the loop and the vmap emission and its MC-4
  bs128 loop ELBO step (with its peak memory), and the INT8 Flipout
  ``qresnet50`` MC-10 bs128 batch: host wall ms, device busy ms, idle
  share, K-H's and K-F's device ms (K-F's Flipout epilogue apart) and the
  batch's launches; a SHA-256 of that batch's logits (the head's uint8
  outputs, dequantized one to one) on fixed seeds; the torch ``qadd`` and
  ``QTensor.requantize`` passes of the batch timed alone; and the
  batch's 540 perturbation GEMMs (``flipout_gemm_work``) with K-F's
  Flipout epilogue beside the route before it (K-F, K-H3's product on the
  output, ``int8.qadd``). Run from a parent's and a change's checkout in
  turns for the before and after (the same file in both: its parts
  missing from a checkout are skipped).
- ``graph``: the benchmark's two prediction batches (ResNet-50 bf16 NHWC
  MC-10, Reparameterization bs128 and Flipout bs256) eager and replayed
  from their CUDA graph (``parallel/mc_graph.py``): the host's issue and
  wall ms a batch, busy ms and rows of a profiled batch, the eager call's
  peak allocation beside the graph pool's reserved bytes, the capture's
  ms, the key's us, and whether three replays equal three eager batches
  bit for bit. A checkout without the graph times eager alone.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPS = 10
BATCH, S, TRAIN_MC, IMAGE = 128, 10, 4, 224
# NVIDIA's data sheet, H100 SXM, dense: HBM bytes/s; bf16, int8, TF32 (on
# the tensor cores) and f32 (outside them) operations/s
HBM_BPS, BF16_OPS, INT8_OPS = 3.35e12, 989e12, 1979e12
TF32_OPS, F32_OPS = 495e12, 67e12
# issued instructions of one counter-hash normal (``btt_hash_normal``,
# csrc/noise.cuh, on the fast paths of cosf and sqrtf), counted once in
# ``cuobjdump -sass`` of the library built for sm_90a (PERF.md, section 6)
PER_NORMAL = 90
# thread instructions the card issues per second: 132 SMs x 4 schedulers
# x 32 lanes at its top SM clock, 1,980 MHz
ISSUE_RATE = 132 * 4 * 32 * 1.98e9
# the head of Bayesian ResNet-50: x (M, K) @ W^T with W (N, K)
HEAD_M, HEAD_K, HEAD_N = 128, 2048, 1000
KB_TAG, KD_TAG, KE_TAG = ("sampled_matmul_kernel", "sampled_matmul_dx_kernel",
                          "sampled_matmul_dw_kernel")
KA_TAG, KC_TAG = "batch_sample_kernel", "noise_grad_kernel"
# the MC-4 steps the ranking of the sampler section counts, each emission
RANK_STEPS = 3
# (in, out, side, count) of ResNet-50's 1x1 stride-1 convs
SITES = [(64, 64, 56, 1), (64, 256, 56, 4), (256, 64, 56, 2),
         (256, 128, 56, 1), (128, 512, 28, 4), (512, 128, 28, 3),
         (512, 256, 28, 1), (256, 1024, 14, 6), (1024, 256, 14, 5),
         (1024, 512, 14, 1), (512, 2048, 7, 3), (2048, 512, 7, 2)]
# (M, K, N, count) of one INT8 qresnet50 forward at batch 128
INT8_GEMMS = [
    (128, 2048, 1000, 1), (6272, 512, 2048, 3), (6272, 1024, 2048, 1),
    (6272, 2048, 512, 2), (6272, 4608, 512, 3), (25088, 256, 1024, 6),
    (25088, 512, 1024, 1), (25088, 1024, 256, 5), (25088, 1024, 512, 1),
    (25088, 2304, 256, 6), (100352, 128, 512, 4), (100352, 256, 512, 1),
    (100352, 512, 128, 3), (100352, 512, 256, 1), (100352, 1152, 128, 4),
    (401408, 64, 64, 1), (401408, 64, 256, 4), (401408, 256, 64, 2),
    (401408, 256, 128, 1), (401408, 576, 64, 3), (1605632, 160, 64, 1)]


def layer_sizes():
    """(sizes, flat): the elements of the per-layer draw buffers of
    Bayesian ResNet-50 in model order, as the training steps draw them with
    the head on K-B (each conv weight, the convs having no bias, then the
    head's bias), and of all its Bayesian weights and biases."""
    import torch

    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large \
        import resnet50
    from bayesian_torch_tpu_torch.models.dnn_to_bnn import (
        iter_bayesian_layers,
    )

    model = resnet50(num_classes=1000, device="meta",
                     generator=torch.Generator().manual_seed(0))
    sizes, flat = [], 0
    for layer in iter_bayesian_layers(model):
        if hasattr(layer, "mu_kernel"):
            sizes.append(layer.mu_kernel.numel())
        if layer.mu_bias is not None:
            sizes.append(layer.mu_bias.numel())
        flat += sum(p.numel() for name, p in layer.named_parameters()
                    if name.startswith("mu_"))
    return sizes, flat


def bound_ms(nbytes, ops, peak):
    return max(nbytes / HBM_BPS, ops / peak) * 1e3


def generation_ms(normals):
    """Least ms to issue the instructions of ``normals`` counter-hash
    normals."""
    return normals * PER_NORMAL / ISSUE_RATE * 1e3


def device_rows(prof):
    """The device rows of a profiler session (no user annotations), in the
    order they started."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation),
                  key=lambda e: e.time_range.start)


def busy_ms(rows):
    """The union of the rows' spans, ms (rows may overlap)."""
    busy, end = 0.0, -math.inf
    for e in rows:
        start, stop = e.time_range.start, e.time_range.end
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


# idle host seconds at each end of a profiler session and before each
# call of device_times, whose rows are then apart by more than half of it;
# the count of device_times' sessions and of those it took again
EDGE_S, GAP_S = 0.05, 0.03
SESSIONS = dict(sessions=0, retried=0)


@contextlib.contextmanager
def device_trace():
    """A profiler session of the card's activity with ``EDGE_S`` of idle
    host time at each end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(EDGE_S)


def bursts(rows, gap_us):
    """``rows`` (in start order) cut wherever the card was idle for more
    than ``gap_us``."""
    out, end = [], -math.inf
    for e in rows:
        if e.time_range.start - end > gap_us:
            out.append([])
        out[-1].append(e)
        end = max(end, e.time_range.end)
    return out


def device_times(*calls):
    """Device ms per call of each ``(fn, tag)`` of ``calls``: the rows whose
    name holds ``tag``, or all rows (``tag`` None). All calls run in one
    profiler session, ``REPS`` times each after a warm-up, each burst of
    launches after ``GAP_S`` of idle host time: the card's idle gaps split
    the rows. Not marks: on the H100 machine the spin kernels
    (``torch.cuda._sleep``) launched first in a session went missing from
    it now and then (in the INT8 phase of ``chip_smoke.py``, in every
    retry), while the calls' rows stayed."""
    import torch

    for fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    # a session cut into the wrong number of bursts is taken again, and
    # logged; after three such sessions each call is timed in a session of
    # its own
    for attempt in range(3 if len(calls) > 1 else 6):
        SESSIONS["sessions"] += 1
        with device_trace() as prof:
            for fn, _ in calls:
                torch.cuda.synchronize()
                time.sleep(GAP_S)
                for _ in range(REPS):
                    fn()
        rows = device_rows(prof)
        cut = bursts(rows, GAP_S / 2 * 1e6)
        if len(cut) == len(calls):
            break
        SESSIONS["retried"] += 1
        print(f"[device_times] session {attempt}: {len(rows)} device rows "
              f"in {len(cut)} bursts, want {len(calls)}; first rows "
              f"{[e.name[:40] for e in rows[:3]]}; taking another",
              flush=True)
    else:
        if len(calls) > 1:
            return [device_times(call)[0] for call in calls]
        raise RuntimeError("no profiler session recorded every call")
    times = []
    for (_, tag), burst in zip(calls, cut):
        got = [e for e in burst if tag is None or tag in e.name]
        if not got:
            raise RuntimeError(f"no device rows named {tag}: "
                               f"{sorted({e.name[:60] for e in burst})}")
        times.append(sum(e.self_device_time_total for e in got) / REPS / 1e3)
    return times


def kg_sites(out):
    import torch
    import torch.nn.functional as F

    from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

    gen = torch.Generator(device="cuda").manual_seed(1)
    tot = {}
    for ci, co, sp, count in SITES:
        P = sp * sp

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").bfloat16()

        x4, w3, g = rnd(BATCH, S, ci, P), rnd(S, co, ci), rnd(BATCH, S, co, P)
        wt = w3.transpose(1, 2).contiguous()
        x, w = x4.reshape(BATCH, S * ci, sp, sp), w3.reshape(S * co, ci, 1, 1)
        xs = x4.reshape(BATCH * S, ci, P)
        times = device_times(
            (lambda: kg.mc_gemm(x4, w3), "mc_gemm"),
            (lambda: kg.pointwise_gemm(xs, w3[0]), "mc_gemm"),
            (lambda: kg.mc_gemm(g, wt), "mc_gemm"),
            (lambda: torch.matmul(w3, x4), None),
            (lambda: torch.matmul(w3[0], xs), None),
            (lambda: torch.matmul(wt, g), None),
            (lambda: F.conv2d(x, w, groups=S), None))
        row = dict(
            site=f"{ci}->{co}@{sp}", count=count,
            **dict(zip(("kg", "kg_s1", "kg_dx", "matmul", "matmul_s1",
                        "matmul_dx", "cudnn"), times)),
            bound=bound_ms(2 * (x4.numel() + w3.numel() + g.numel()),
                           2 * BATCH * S * co * P * ci, BF16_OPS))
        print("[K-G] " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
        out.append(row)
        for k, v in row.items():
            if isinstance(v, float):
                tot[k] = tot.get(k, 0.0) + count * v
        del x4, w3, g, wt, x, w, xs
    print("[K-G] sums over the 33 sites: " + ", ".join(
        f"{k} {v:.3f}" for k, v in tot.items()), flush=True)
    return tot


def kg_cl_sites(out):
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

    gen = torch.Generator(device="cuda").manual_seed(3)
    tot = {}
    for ci, co, sp, count in SITES:
        M = BATCH * sp * sp

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").bfloat16()

        x3, w3, g = rnd(M, S, ci), rnd(S, co, ci), rnd(M, S, co)
        wt = w3.transpose(1, 2).contiguous()
        rows, w0 = x3.reshape(M * S, ci), w3[0]
        times = device_times(
            (lambda: kg.mc_gemm_cl(x3, w3), "mc_gemm_cl"),
            (lambda: kg.pointwise_gemm_cl(rows, w0), "mc_gemm_cl"),
            (lambda: kg.mc_gemm_cl(g, wt), "mc_gemm_cl"),
            (lambda: torch.einsum("msc,soc->mso", x3, w3), None),
            (lambda: torch.einsum("mc,oc->mo", rows, w0), None),
            (lambda: torch.einsum("mso,sco->msc", g, wt), None))
        row = dict(
            site=f"{ci}->{co}@{sp}", count=count,
            **dict(zip(("kgcl", "kgcl_s1", "kgcl_dx", "einsum", "einsum_s1",
                        "einsum_dx"), times)),
            bound=bound_ms(2 * (x3.numel() + w3.numel() + g.numel()),
                           2 * M * S * co * ci, BF16_OPS))
        print("[K-G cl] " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
        out.append(row)
        for k, v in row.items():
            if isinstance(v, float):
                tot[k] = tot.get(k, 0.0) + count * v
        del x3, w3, g, wt, rows, w0
    print("[K-G cl] sums over the 33 sites: " + ", ".join(
        f"{k} {v:.3f}" for k, v in tot.items()), flush=True)
    return tot


def probe(out):
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import mc_gemm as kg

    gen = torch.Generator(device="cuda").manual_seed(2)
    for M, K, N in ((4096, 4096, 4096), (8192, 4096, 4096)):
        for dtype in (torch.bfloat16, torch.int8):
            if dtype == torch.int8:
                a = torch.randint(-127, 127, (M, K), dtype=dtype,
                                  device="cuda", generator=gen)
                b = torch.randint(-127, 127, (K, N), dtype=dtype,
                                  device="cuda", generator=gen)
                lib = torch._int_mm
            else:
                a = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
                b = torch.randn(K, N, device="cuda", generator=gen).to(dtype)
                lib = torch.matmul
            kg_ms, lib_ms = device_times((lambda: kg.matmul(a, b), "mc_gemm"),
                                         (lambda: lib(a, b), None))
            row = dict(shape=f"{M}x{K}x{N} {dtype}", kg=kg_ms, lib=lib_ms)
            print(f"[probe] {row}", flush=True)
            out.append(row)


def kf(out):
    import torch

    from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kfm

    gen = torch.Generator(device="cuda").manual_seed(3)
    tot = dict(kf=0.0, int_mm=0.0, bound=0.0)
    for M, K, N, count in INT8_GEMMS:
        x = torch.randint(0, 256, (M, K), dtype=torch.uint8, device="cuda",
                          generator=gen)
        w = torch.randint(-128, 128, (N, K), dtype=torch.int8,
                          device="cuda", generator=gen)
        b = torch.randn(N, device="cuda", generator=gen)
        xc = (x.int() - 128).to(torch.int8)
        kf_ms, lib_ms = device_times(
            (lambda: kfm.qmatmul_requant(x, 0.02, 117, w, 0.01, b, 3.0, 128),
             "qmatmul"),
            (lambda: torch._int_mm(xc, w.t()), None))
        row = dict(
            shape=f"{M}x{K}x{N}", count=count, kf=kf_ms, int_mm=lib_ms,
            bound=bound_ms(M * K + N * K + M * N + 8 * N, 2 * M * N * K,
                           INT8_OPS))
        print(f"[K-F] {row}", flush=True)
        out.append(row)
        for k in tot:
            tot[k] += count * row[k]
        del x, w, b, xc
    print(f"[K-F] sums over one forward's 54 GEMMs: {tot}", flush=True)
    return tot


def unfused_dw(seed, g, x, zeros, ones):
    """K-E's function without the fused kernel, g (S, M, N), x (S, M, K)
    or shared (M, K): dmu as one torch.matmul over the S*M rows; the S eps
    windows drawn by K-A (mu = ``zeros``, sigma = ``ones``: the same salts
    as K-E's), then torch.bmm per lane and (d * eps).sum(0) for dsigma."""
    import torch

    from bayesian_torch_tpu_torch.ops.cuda.sampled_weights import (
        sample_scaled_normals_batch as ka,
    )

    S, M, N = g.shape
    xs = x.expand(S, *x.shape[-2:]) if x.dim() == 2 else x
    dmu = torch.matmul(g.reshape(S * M, N).T, xs.reshape(S * M, -1))
    eps = ka(seed, zeros, ones, S, torch.float32)
    d = torch.bmm(g.transpose(1, 2), xs)
    return dmu, (d * eps).sum(0)


def sampled(out):
    """K-B, K-D and K-E at the head, beside the unfused route."""
    import torch
    import torch.nn.functional as F

    from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb
    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka

    torch.backends.cuda.matmul.allow_tf32 = False
    M, K, N = HEAD_M, HEAD_K, HEAD_N
    gen = torch.Generator(device="cuda").manual_seed(4)
    mu = 0.1 * torch.randn(N, K, generator=gen, device="cuda")
    rho = torch.randn(N, K, generator=gen, device="cuda") * 0.1 - 3.0
    sigma = F.softplus(rho)
    x = torch.randn(S, M, K, generator=gen, device="cuda")
    g = torch.randn(4, M, N, generator=gen, device="cuda")
    seed, f32 = 4242, torch.float32

    def draws(s):
        return ka.sample_scaled_normals_batch(seed, mu, sigma, s, f32)

    zeros, ones = torch.zeros_like(mu), torch.ones_like(mu)

    def row(what, s, fn, tag, nbytes, unfused=None):
        # three TF32 products on the tensor cores (split TF32); K-E's
        # epilogue (one multiply and two adds an element and lane on the
        # f32 pipe) is not counted
        terms = dict(
            bytes=nbytes / HBM_BPS * 1e3,
            operations=3 * 2 * s * M * N * K / TF32_OPS * 1e3,
            generation=generation_ms(s * N * K))
        calls = [(fn, tag)] + ([(unfused, None)] if unfused else [])
        times = device_times(*calls)
        r = dict(kernel=what, S=s, ms=times[0],
                 bound_ms=max(terms.values()),
                 bound_by=max(terms, key=terms.get),
                 **{f"{k}_ms": v for k, v in terms.items()})
        if unfused is not None:
            r["unfused_ms"] = times[1]
        print(f"[sampled] {r}", flush=True)
        out.append(r)

    w_bytes = 2 * 4 * N * K
    row("K-B", 1, lambda: kb.sampled_matmul(seed, x[0], mu, rho,
                                            out_dtype=f32), KB_TAG,
        4 * (M * K + M * N) + w_bytes,
        lambda: torch.matmul(x[0], draws(1)[0].T))
    for s in (4, S):
        xs = x[:s]
        row("K-B lanes, x per lane", s,
            lambda: kb.sampled_matmul_batched(seed, xs, mu, rho, s), KB_TAG,
            4 * s * (M * K + M * N) + w_bytes,
            lambda: torch.matmul(xs, draws(s).transpose(1, 2)))
        row("K-B lanes, x shared", s,
            lambda: kb.sampled_matmul_batched(seed, x[0], mu, rho, s),
            KB_TAG, 4 * (M * K + s * M * N) + w_bytes,
            lambda: torch.matmul(x[0], draws(s).transpose(1, 2)))
    row("K-D", 1, lambda: kb.sampled_matmul_dx(seed, g[0], mu, sigma),
        KD_TAG, 4 * (M * N + M * K) + w_bytes,
        lambda: torch.matmul(g[0], draws(1)[0]))
    row("K-D lanes", 4,
        lambda: kb.sampled_matmul_dx_batched(seed, g, mu, sigma), KD_TAG,
        4 * 4 * (M * N + M * K) + w_bytes, lambda: torch.matmul(g, draws(4)))
    row("K-E", 1, lambda: kb.sampled_matmul_dw(seed, g[0], x[0]), KE_TAG,
        4 * (M * N + M * K) + w_bytes,
        lambda: unfused_dw(seed, g[:1], x[0], zeros, ones))
    row("K-E lanes", 4, lambda: kb.sampled_matmul_dw_batched(seed, g, x[:4]),
        KE_TAG, 4 * 4 * (M * N + M * K) + w_bytes,
        lambda: unfused_dw(seed, g, x[:4], zeros, ones))


def windowed(out):
    """K-B, K-D and K-E under a counter window beside the whole launch of
    the same size at the head (see the docstring)."""
    import torch
    import torch.nn.functional as F

    from bayesian_torch_tpu_torch.ops.cuda import sampled_matmul as kb

    torch.backends.cuda.matmul.allow_tf32 = False
    M, K, N = HEAD_M, HEAD_K, HEAD_N
    gen = torch.Generator(device="cuda").manual_seed(5)
    mu = 0.1 * torch.randn(N, K, generator=gen, device="cuda")
    rho = torch.randn(N, K, generator=gen, device="cuda") * 0.1 - 3.0
    sigma = F.softplus(rho)
    x = torch.randn(S, M, K, generator=gen, device="cuda")
    g = torch.randn(S, M, N, generator=gen, device="cuda")
    seed, half = 4343, N // 2
    # a shard's rows: its own tensors, as shard_params_tp keeps them
    mu_r, rho_r = mu[half:].clone(), rho[half:].clone()
    sigma_r, g_r = sigma[half:].clone(), g[:, :, half:].contiguous()
    rows = (0, N * K, half * K)

    def lanes(s):
        # a rank's lanes [s, 2 s) of a 2 s-lane launch
        return (s, N * K, 0)

    cases = [
        ("K-B lanes, lanes 5-9 of 10", KB_TAG,
         lambda: kb.sampled_matmul_batched(seed, x[5:], mu, rho, 5),
         lambda: kb.sampled_matmul_batched(seed, x[5:], mu, rho, 5,
                                           window=lanes(5))),
        ("K-B lanes, rows 500-999, S = 2", KB_TAG,
         lambda: kb.sampled_matmul_batched(seed, x[:2], mu_r, rho_r, 2),
         lambda: kb.sampled_matmul_batched(seed, x[:2], mu_r, rho_r, 2,
                                           window=rows)),
        ("K-B, rows 500-999", KB_TAG,
         lambda: kb.sampled_matmul(seed, x[0], mu_r, rho_r),
         lambda: kb.sampled_matmul(seed, x[0], mu_r, rho_r, window=rows)),
        ("K-D lanes, lanes 2-3 of 4", KD_TAG,
         lambda: kb.sampled_matmul_dx_batched(seed, g[:2], mu, sigma),
         lambda: kb.sampled_matmul_dx_batched(seed, g[:2], mu, sigma,
                                              window=lanes(2))),
        ("K-D, rows 500-999", KD_TAG,
         lambda: kb.sampled_matmul_dx(seed, g_r[0], mu_r, sigma_r),
         lambda: kb.sampled_matmul_dx(seed, g_r[0], mu_r, sigma_r,
                                      window=rows)),
        ("K-E lanes, lanes 2-3 of 4", KE_TAG,
         lambda: kb.sampled_matmul_dw_batched(seed, g[:2], x[:2]),
         lambda: kb.sampled_matmul_dw_batched(seed, g[:2], x[:2],
                                              window=lanes(2))),
        ("K-E, rows 500-999", KE_TAG,
         lambda: kb.sampled_matmul_dw(seed, g_r[0], x[0]),
         lambda: kb.sampled_matmul_dw(seed, g_r[0], x[0], window=rows)),
    ]
    for what, tag, whole, window in cases:
        # in turns, whole and windowed twice, in one session
        t = device_times((whole, tag), (window, tag), (whole, tag),
                         (window, tag))
        r = dict(kernel=what, whole_ms=(t[0] + t[2]) / 2,
                 window_ms=(t[1] + t[3]) / 2, times=t)
        r["ratio"] = r["window_ms"] / r["whole_ms"]
        print(f"[windowed] {r}", flush=True)
        out.append(r)


def sampler(out):
    """K-A and K-C, flat and per layer, with bounds (see the docstring)."""
    import torch
    import torch.nn.functional as F

    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka

    sizes, flat = layer_sizes()
    gen = torch.Generator(device="cuda").manual_seed(6)

    bf16, f32 = torch.bfloat16, torch.float32

    def posterior(n, dtype):
        mu = 0.1 * torch.randn(n, generator=gen, device="cuda")
        rho = torch.randn(n, generator=gen, device="cuda") * 0.1 - 3.0
        return mu.to(dtype), rho.to(dtype), F.softplus(rho).to(dtype)

    def grads(s, n, dtype):
        return torch.randn((s, n), generator=gen, device="cuda").to(dtype)

    # (what, S, repeats of the 54 per layer (0: flat only), operands' dtype
    # (mu, rho and sigma; g too for K-C), bytes an element (operands read,
    # out written), tag, the call on one buffer). The steps' modes take
    # the operands their paths give them: the draw loop samples in the
    # compute dtype (bf16 mu and rho, so bf16 g); the vmap step samples
    # from f32 mu and sigma into bf16 draws, so bf16 g.
    modes = [
        ("K-A presample", 10, 0, f32, 8 + 2 * 10, KA_TAG,
         lambda p, s: ka.sample_scaled_normals_batch(s, p[0], p[2], 10, bf16)),
        ("K-A rho, f32 in", 1, 0, f32, 8 + 2, KA_TAG,
         lambda p, s: ka.sample_gaussian(s, p[0], p[1], bf16)),
        ("K-A rho (loop step)", 1, 4, bf16, 4 + 2, KA_TAG,
         lambda p, s: ka.sample_gaussian(s, p[0], p[1], bf16)),
        ("K-A S=4 (vmap step)", 4, 1, f32, 8 + 2 * 4, KA_TAG,
         lambda p, s: ka.sample_scaled_normals_batch(s, p[0], p[2], 4, bf16)),
        ("K-C drho, f32 g and rho", 1, 0, f32, 4 + 4 + 4, KC_TAG,
         lambda p, s: ka.drho(s, p[3][0], p[1])),
        ("K-C drho (loop step)", 1, 4, bf16, 2 + 2 + 4, KC_TAG,
         lambda p, s: ka.drho(s, p[3][0], p[1])),
        ("K-C dsigma (vmap step)", 4, 1, bf16, 2 * 4 + 4, KC_TAG,
         lambda p, s: ka.dsigma(s, p[3])),
    ]

    def bound(n, s, per_elem):
        terms = dict(bytes=per_elem * n / HBM_BPS * 1e3,
                     generation=generation_ms(s * n))
        return max(terms.values()), max(terms, key=terms.get)

    for what, s, repeats, dtype, per_elem, tag, fn in modes:
        # K-C dsigma's mu and sigma are f32 on its path; only g is read
        p_dtype = f32 if "dsigma" in what else dtype
        one = [(*posterior(flat, p_dtype), grads(s, flat, dtype)
                if what.startswith("K-C") else None)]
        seed = 1234
        flat_ms, = device_times((lambda: fn(one[0], seed), tag))
        del one
        b, by = bound(flat, s, per_elem)
        row = dict(kernel=what, S=s, operands=str(dtype).split(".")[-1],
                   flat_n=flat, flat_ms=flat_ms,
                   flat_bound_ms=b, bound_by=by)
        if repeats:
            bufs = [(*posterior(n, p_dtype), grads(s, n, dtype)
                     if what.startswith("K-C") else None) for n in sizes]

            def step():
                for r in range(repeats):
                    for i, p in enumerate(bufs):
                        fn(p, seed + 97 * r + i)

            step_ms, = device_times((step, tag))
            del bufs
            row.update(launches=repeats * len(sizes), step_ms=step_ms,
                       step_bound_ms=repeats * sum(
                           bound(n, s, per_elem)[0] for n in sizes))
        print(f"[sampler] {row}", flush=True)
        out.append(row)
        torch.cuda.empty_cache()


def rank(rows):
    """K-A's per-layer modes, K-C and K-E by launches x (device time -
    bound) over ``RANK_STEPS`` loop and vmap MC-4 steps each."""
    gaps = {r["kernel"]: RANK_STEPS * (r["step_ms"] - r["step_bound_ms"])
            for r in rows.get("sampler", []) if "step_ms" in r}
    ke = {r["S"]: r["ms"] - r["bound_ms"] for r in rows.get("sampled", [])
          if r["kernel"].startswith("K-E")}
    if 1 in ke and 4 in ke:
        # four S = 1 launches a loop step, one with lanes a vmap step
        gaps["K-E (loop and vmap steps)"] = RANK_STEPS * (4 * ke[1] + ke[4])
    ranked = dict(sorted(gaps.items(), key=lambda kv: -kv[1]))
    print("[rank] launches x (device ms - bound ms) over "
          f"{RANK_STEPS} loop + {RANK_STEPS} vmap MC-4 steps: " + ", ".join(
              f"{k} {v:.3f}" for k, v in ranked.items()), flush=True)
    return ranked


def wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def window(fn, tags):
    """One profiled run of ``fn``: wall ms, device busy ms, idle share and
    the device ms of the rows holding each of ``tags`` ({key: tag})."""
    import torch

    torch.cuda.synchronize()
    with device_trace() as prof:
        wall = wall_ms(fn)
    rows = device_rows(prof)
    busy = busy_ms(rows)
    return dict(wall_ms=wall, busy_ms=busy, idle=1 - busy / wall, **{
        f"{k}_ms": sum(e.self_device_time_total for e in rows
                       if tag in e.name) / 1e3 for k, tag in tags.items()})


def report(out, section, what, walls, windows):
    r = dict(path=what, wall_ms=walls, wall_median=statistics.median(walls),
             profiled=windows)
    print(f"[{section}] {what}: wall median {r['wall_median']:.1f} ms of "
          f"{len(walls)}; profiled: " + "; ".join(
              ", ".join(f"{k} {v:.4g}" for k, v in w.items())
              for w in windows), flush=True)
    out.append(r)


def bf16_resnet50(images, **kw):
    """ResNet-50 in bf16 with BN running statistics from one training-mode
    batch (so that 50 layers of eval-mode BN keep random weights'
    activations finite), in eval mode."""
    import torch
    from torch import nn

    from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large \
        import resnet50

    model = resnet50(num_classes=1000,
                     generator=torch.Generator().manual_seed(5),
                     device="cuda", **kw)
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    with torch.no_grad():
        model(images())
    for m in bns:
        m.momentum = 0.1
    return model.eval()


def paths(out):
    """The loop paths that run K-B and K-D, wall and device busy time."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step
    from bayesian_torch_tpu_torch.parallel import mc_forward

    gen = torch.Generator(device="cuda").manual_seed(5)

    def images():
        return torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen,
                           device="cuda")

    tags = dict(ka=KA_TAG, kb=KB_TAG, kc=KC_TAG, kd=KD_TAG, ke=KE_TAG)
    model = bf16_resnet50(images)
    model.fc.impl = "pallas"
    x = images()

    def infer():
        mc_forward(model, x, S, presample="off", reduce="mean",
                   return_kl=False)

    walls = [wall_ms(infer) for _ in range(6)][1:]
    report(out, "paths", f"loop MC-{S} bs{BATCH}, head on K-B, presample "
           "off", walls, [window(infer, tags) for _ in range(3)])

    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH, emission="scan")
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")

    def train():
        step(model, opt, x, y)

    walls = [wall_ms(train) for _ in range(8)][2:]
    report(out, "paths", f"loop MC-{TRAIN_MC} bs{BATCH} ELBO step, head on "
           "K-B and K-D", walls, [window(train, tags) for _ in range(3)])

    vstep = make_train_step(TRAIN_MC, BATCH, emission="vmap")

    def train_vmap():
        vstep(model, opt, x, y)

    walls = [wall_ms(train_vmap) for _ in range(8)][2:]
    report(out, "paths", f"vmap MC-{TRAIN_MC} bs{BATCH} ELBO step, head on "
           "K-B, K-D and K-E with lanes", walls,
           [window(train_vmap, tags) for _ in range(3)])


def nhwc_dot(out):
    """The NHWC paths that run K-G channels-last: wall and device busy
    time of the vmap MC-10 bs128 batch and the vmap MC-4 bs128 ELBO step
    with ``CONV_1X1_DOT``, and K-G cl's device ms in them."""
    import torch

    from bayesian_torch_tpu_torch.examples._engine import make_train_step
    from bayesian_torch_tpu_torch.ops import conv as conv_ops
    from bayesian_torch_tpu_torch.parallel import mc_forward

    gen = torch.Generator(device="cuda").manual_seed(6)

    def images():
        return torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen,
                           device="cuda")

    tags = dict(kgcl="mc_gemm_cl")
    model = bf16_resnet50(images, data_format="NHWC")
    x = images()
    conv_ops.CONV_1X1_DOT = True
    try:
        def infer():
            with torch.no_grad():
                mc_forward(model, x, S, reduce="mean", return_kl=False,
                           emission="vmap")

        walls = [wall_ms(infer) for _ in range(6)][1:]
        report(out, "nhwc", f"NHWC vmap MC-{S} bs{BATCH} CONV_1X1_DOT",
               walls, [window(infer, tags) for _ in range(2)])
        model.train()
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(TRAIN_MC, BATCH, emission="vmap")
        y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")

        def train():
            step(model, opt, x, y)

        walls = [wall_ms(train) for _ in range(7)][2:]
        report(out, "nhwc", f"NHWC vmap MC-{TRAIN_MC} bs{BATCH} ELBO step "
               "CONV_1X1_DOT", walls, [window(train, tags) for _ in range(2)])
    finally:
        conv_ops.CONV_1X1_DOT = False


# --- K-H: the Flipout signs -------------------------------------------------

SIGN_TAG, QSIGN_TAG = "sign_kernel", "QSignOp"
# K-F's Flipout instantiation, by the type of its epilogue argument
KF_FLIP_TAG = "BttFlipEpilogue"
# (a scale, a zero point, sign scale, sign zero point, out scale, out zero
# point): a calibrated INT8 Flipout layer's sign product
QSIGN_SCALES = (0.031, 117.0, 0.0079, 127.0, 0.045, 121.0)
# the integer instructions of one sign (the counter, splitmix32's three
# xor-shifts and two multiplies, the salt and the bit), a bound by
# instruction issue beside the bytes
PER_SIGN = 12


def resnet50_sites(batch=BATCH):
    """(input shape, output shape) of ResNet-50's 54 Bayesian layers (53
    convs and the head) at ``batch`` images of 224^2, NCHW, in model order:
    the shapes of the sign tensors of one Flipout forward (a deterministic
    ResNet-50 on the meta device)."""
    import torch

    from bayesian_torch_tpu_torch.models.deterministic.resnet_large import (
        resnet50,
    )

    model = resnet50(num_classes=1000, device="meta")
    sites = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: sites.append(
        (tuple(inp[0].shape), tuple(out.shape))))
        for m in model.modules()
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.empty(batch, 3, IMAGE, IMAGE, device="meta"))
    for h in hooks:
        h.remove()
    return sites


def resnet50_gemms(batch=BATCH):
    """(output shape, GEMM depth K) of ResNet-50's 54 Bayesian layers at
    ``batch`` images of 224^2, NCHW, in model order: the GEMM ``ops.int8``
    gives each INT8 layer (K = C * prod(kernel), widened to a multiple of
    16; the head's K its input features)."""
    import torch

    from bayesian_torch_tpu_torch.models.deterministic.resnet_large import (
        resnet50,
    )

    model = resnet50(num_classes=1000, device="meta")
    gemms = []

    def hook(mod, inp, out):
        k = mod.in_features if isinstance(mod, torch.nn.Linear) else \
            mod.in_channels // mod.groups * math.prod(mod.kernel_size)
        gemms.append((tuple(out.shape), k + (-k % 16)))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.empty(batch, 3, IMAGE, IMAGE, device="meta"))
    for h in hooks:
        h.remove()
    return gemms


def _sign_salt(draw, side):
    return (0x5A17 + 7919 * (2 * draw + side)) & 0xFFFFFFFF


def sign_work(draws=S, batch=BATCH, dtype=None, route="kernel"):
    """The sign work of one Flipout MC-``draws`` batch at ``batch`` images
    through the draw loop (what ``chip_smoke.py``'s phase 26 runs a
    batch): per draw and layer its input's flip (K-H1) and its output's
    combine (K-H2) in ``dtype`` (bf16 by default), and the INT8 layer's two
    sign products on uint8 tensors (K-H3 products, the output channels-last
    as ``ops.int8.qconv`` gives it), each under salts of its own; where K-H3
    takes it, its input pass (``requant``: a QTensor payload requantized
    and multiplied by the signs in one read; K-H3 input pass), the form
    the INT8 Flipout layer runs since K-F's Flipout epilogue took the
    output's product. One input of each shape serves every draw.
    ``route``: "kernel" (the K-H wrappers), "plain" (their plain versions)
    or "hash" (``rademacher_fused`` and the product, the route before
    K-H). Returns {kernel: (fn, bytes a call, elements a call)}."""
    import inspect

    import torch

    from bayesian_torch_tpu_torch.ops import int8 as q
    from bayesian_torch_tpu_torch.ops import sampling as ts

    dtype = torch.bfloat16 if dtype is None else dtype
    gen = torch.Generator(device="cuda").manual_seed(11)
    sites = resnet50_sites(batch)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def uint8(shape, last=False):
        a = torch.randint(0, 256, shape, generator=gen, device="cuda",
                          dtype=torch.uint8)
        return a.contiguous(memory_format=torch.channels_last) \
            if last and a.dim() == 4 else a

    xs = [randn(i) for i, _ in sites]
    means = [randn(o) for _, o in sites]
    perts = [randn(o) for _, o in sites]
    a_in = [uint8(i, last=True) for i, _ in sites]
    a_out = [uint8(o, last=True) for _, o in sites]
    sa, za, ss, zs, so, zo = QSIGN_SCALES
    passes = False
    if route == "hash":
        def flip(x, d, side):
            return x * ts.rademacher_fused(_sign_salt(d, side), x.shape,
                                           x.dtype, x.device)

        def combine(m, p, d):
            return m + p * ts.rademacher_fused(_sign_salt(d, 1), p.shape,
                                               p.dtype, p.device)

        def qsign(a, d, side):
            sign = ts.rademacher_fused(_sign_salt(d, side), a.shape,
                                       torch.float32, a.device)
            return q.qmul(a, sa, q.quantize_uint8(sign, ss, zs), ss, so, zo,
                          a_zp=za, b_zp=zs, out_dtype=torch.uint8)
    else:
        from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh

        plain = route == "plain"
        fl = kh.sign_flip_plain if plain else kh.sign_flip
        co = kh.sign_combine_plain if plain else kh.sign_combine
        qs = kh.qsign_mul_plain if plain else kh.qsign_mul
        passes = "requant" in inspect.signature(kh.qsign_mul).parameters

        def flip(x, d, side):
            return fl(x, ts.sign_block([_sign_salt(d, side)], x.shape))

        def combine(m, p, d):
            return co(m, p, ts.sign_block([_sign_salt(d, 1)], p.shape))

        def qsign(a, d, side, **kw):
            return qs(a, sa, za, ts.sign_block([_sign_salt(d, side)],
                                               a.shape), ss, zs, so, zo,
                      **kw)

    def run_flip():
        for d in range(draws):
            for x in xs:
                flip(x, d, 0)

    def run_combine():
        for d in range(draws):
            for m, p in zip(means, perts):
                combine(m, p, d)

    def run_qsign():
        for d in range(draws):
            for a, b in zip(a_in, a_out):
                qsign(a, d, 0)
                qsign(b, d, 1)

    def run_pass():
        # the payload at a QTensor's scale and zero point of its own
        for d in range(draws):
            for a in a_in:
                qsign(a, d, 0, requant=(sa * 1.37, 119))

    n_in = draws * sum(x.numel() for x in xs)
    n_out = draws * sum(m.numel() for m in means)
    size = torch.finfo(dtype).bits // 8
    work = {"K-H1": (run_flip, 2 * size * n_in, n_in),
            "K-H2": (run_combine, 3 * size * n_out, n_out),
            "K-H3 products": (run_qsign, 2 * (n_in + n_out), n_in + n_out)}
    if passes:
        work["K-H3 input pass"] = (run_pass, 3 * n_in, n_in)
    return work


# (x scale, x zero point, weight scale, p scale, p zero point, mean scale,
# mean zero point, sign scale, sign zero point, signed p scale, its zero
# point, sum scale, sum zero point): a calibrated INT8 Flipout layer's
# perturbation product and the chain after it
FLIP_SCALES = (0.031, 117.0, 0.0123, 0.052, 119.0, 0.043, 121.0, 0.0079,
               127.0, 0.049, 124.0, 0.071, 126.0)


def flipout_gemm_work(draws=S, route="kernel"):
    """The output side of one INT8 Flipout ``qresnet50`` MC-``draws`` bs128
    batch through the loop: per draw, the 54 perturbation GEMMs
    (``INT8_GEMMS``; NCHW outputs, the head's (B, N)) and the rest of the
    layer's chain after each, ``qadd(mean, qmul(p, quantize_uint8(
    signs)))``, each draw under a salt of its own. ``route``: "kernel" (K-F's
    Flipout epilogue), "plain" (its plain version), "unfused" (the route
    before it: K-F, K-H3's sign product on the output, ``int8.qadd``). One
    operand set a shape serves every draw and layer of it. Returns (fn,
    bytes a call, int8 operations a call, GEMMs a call); None for "kernel"
    and "plain" in a checkout without the epilogue."""
    import torch

    from bayesian_torch_tpu_torch.ops import int8 as q
    from bayesian_torch_tpu_torch.ops import sampling as ts
    from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh
    from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kfm

    if route != "unfused" and not hasattr(kfm, "qmatmul_requant_flipout"):
        return None
    s6, z6, s1, s7, z7, s3, z3, s5, z5, s8, z8, s9, z9 = FLIP_SCALES
    gen = torch.Generator(device="cuda").manual_seed(13)
    ops = []
    nbytes = flops = gemms = 0
    for M, K, N, count in INT8_GEMMS:
        x = torch.randint(0, 256, (M, K), dtype=torch.uint8, device="cuda",
                          generator=gen)
        w = torch.randint(-128, 128, (N, K), dtype=torch.int8,
                          device="cuda", generator=gen)
        b = torch.randn(N, device="cuda", generator=gen)
        mean = torch.randint(0, 256, (M, N), dtype=torch.uint8,
                             device="cuda", generator=gen)
        side = math.isqrt(M // BATCH)
        out = (BATCH, N, side, side) if M > BATCH else (BATCH, N)
        ops.append((x, w, b, mean, out, count))
        nbytes += count * (M * K + N * K + 2 * M * N + 8 * N)
        flops += count * 2 * M * N * K
        gemms += count

    def nchw(t, out):
        """(M, N) in the GEMM's layout as the layer's NCHW output."""
        if len(out) == 2:
            return t
        B, N, H, W = out
        return t.view(B, H, W, N).permute(0, 3, 1, 2)

    def epi(mean, out, d):
        signs = kh.OutputSigns(ts.sign_block([_sign_salt(d, 1)], out), 1)
        return kfm.FlipoutEpilogue(mean, s3, z3, signs, s5, z5, s8, z8, s9,
                                   z9)

    def gemm(x, w, b, mean, out, d):
        if route == "kernel":
            return kfm.qmatmul_requant_flipout(x, s6, z6, w, s1, b, s7, z7,
                                               epi(mean, out, d))
        if route == "plain":
            args = kfm.requant_args(w, z6, s6, s1, b, s7)
            return kfm.qmatmul_requant_flipout_plain(x, w, *args, z7, s7,
                                                     epi(mean, out, d))
        p = nchw(kfm.qmatmul_requant(x, s6, z6, w, s1, b, s7, z7), out)
        p2 = kh.qsign_mul(p, s7, z7, ts.sign_block([_sign_salt(d, 1)], out),
                          s5, z5, s8, z8)
        return q.qadd(nchw(mean, out), s3, p2, s8, s9, z9, a_zp=z3,
                      b_zp=z8, out_dtype=torch.uint8)

    def run():
        for d in range(draws):
            for x, w, b, mean, out, count in ops:
                for _ in range(count):
                    gemm(x, w, b, mean, out, d)

    return run, draws * nbytes, draws * flops, draws * gemms


def sign_bound(nbytes, elements):
    """(bound ms, its term): the bytes at the card's rate, or the hash's
    integer instructions at its issue rate, whichever is longer."""
    terms = dict(bytes=nbytes / HBM_BPS * 1e3,
                 operations=elements * PER_SIGN / ISSUE_RATE * 1e3)
    term = max(terms, key=terms.get)
    return terms[term], term


def signs(out):
    """K-H1, K-H2 and K-H3 over one Flipout MC-10 bs128 batch's sign work
    through the draw loop (``sign_work``): each kernel's device time beside
    its plain version's and its bound; in a checkout without K-H, the
    route before it (the hash in torch, then the product), timed the same
    way as the plain versions."""
    import importlib.util

    import torch

    has_kh = importlib.util.find_spec(
        "bayesian_torch_tpu_torch.ops.cuda.flipout_signs") is not None
    routes = ("kernel", "plain") if has_kh else ("hash",)
    for route in routes:
        work = sign_work(route=route)
        for name, (fn, nbytes, elements) in work.items():
            if route == "kernel":
                ms = device_times((fn, QSIGN_TAG if name.startswith("K-H3")
                                   else SIGN_TAG))[0]
            else:
                # the plain routes run ~15 torch passes a tensor: one warm
                # call, then one timed by CUDA events
                fn()
                ms = event_ms(fn)
            bound, term = sign_bound(nbytes, elements)
            r = dict(kernel=name, route=route, ms=ms, bound_ms=bound,
                     bound_by=term, gbytes=nbytes / 1e9)
            print(f"[signs] {r}", flush=True)
            out.append(r)
        del work
        torch.cuda.empty_cache()


def event_ms(fn):
    """Device ms of one call of ``fn``, by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def flipout_gemms(out):
    """The INT8 Flipout batch's 540 perturbation GEMMs with the chain after
    them (``flipout_gemm_work``): K-F's Flipout epilogue (device time of
    its rows) beside the route before it (K-F, K-H3's output product and
    torch's qadd: all its device rows) and the bound (bytes: patches,
    weights, the mean read, the output written; or int8 operations)."""
    import torch

    for route in ("kernel", "unfused"):
        work = flipout_gemm_work(route=route)
        if work is None:
            continue
        fn, nbytes, flops, gemms = work
        ms = device_times((fn, KF_FLIP_TAG if route == "kernel"
                           else None))[0]
        r = dict(route=route, gemms=gemms, ms=ms,
                 bound_ms=bound_ms(nbytes, flops, INT8_OPS),
                 bound_by="bytes" if nbytes / HBM_BPS > flops / INT8_OPS
                 else "operations", gbytes=nbytes / 1e9)
        print(f"[flipout gemms] {r}", flush=True)
        out.append(r)
        del work, fn
        torch.cuda.empty_cache()


def int8_glue(qmodel, x):
    """The torch passes K-F's Flipout epilogue and K-H3's input pass
    replace, timed alone (CUDA events) at one INT8 Flipout MC-10 batch's
    shapes: the ``qadd`` of each layer's mean and signed perturbation (540
    calls) and the ``QTensor.requantize`` of each layer input that arrives
    as a QTensor at another scale; and the layers that take a float input
    (whose ``quantize_uint8`` stays). Shapes from one forward's hooks."""
    import torch

    from bayesian_torch_tpu_torch.ops import int8 as q
    from bayesian_torch_tpu_torch.ops.qtensor import QTensor

    layers = [m for m in qmodel.modules() if hasattr(m, "quant_dict")]
    seen = []
    hooks = [m.register_forward_hook(lambda mod, inp, o: seen.append(
        (mod, inp[0], o[0] if isinstance(o, tuple) else o))) for m in layers]
    with torch.no_grad():
        qmodel(x)
    for h in hooks:
        h.remove()
    gen = torch.Generator(device="cuda").manual_seed(17)
    adds, requants, floats = [], [], 0
    for mod, inp, o in seen:
        s2, z2 = mod._qd(2)
        s3, z3 = mod._qd(3)
        s8, z8 = mod._qd(8)
        s9, z9 = mod._qd(9)
        shape = tuple(o.q.shape) if isinstance(o, QTensor) else tuple(o.shape)
        a = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                          generator=gen)
        adds.append((a, a.clone(), (s3, s8, s9, z9, z3, z8)))
        if isinstance(inp, QTensor) and (inp.scale, inp.zp) != (s2, z2):
            requants.append((QTensor(inp.q.clone(), inp.scale, inp.zp),
                             (s2, z2)))
        floats += not isinstance(inp, QTensor)

    def run_adds():
        for _ in range(S):
            for m, p, (s3, s8, s9, z9, z3, z8) in adds:
                q.qadd(m, s3, p, s8, s9, z9, a_zp=z3, b_zp=z8,
                       out_dtype=torch.uint8)

    def run_requants():
        for _ in range(S):
            for qt, (s2, z2) in requants:
                qt.requantize(s2, z2)

    r = {}
    for name, fn in (("qadd", run_adds), ("requantize", run_requants)):
        fn()
        r[f"{name}_ms"] = event_ms(fn)
    r.update(qadd_calls=S * len(adds), requantize_calls=S * len(requants),
             float_inputs=S * floats)
    return r


def flipout(out):
    """The Flipout paths that K-H serves, in any checkout: Flipout
    ResNet-50 (bf16) MC-10 bs128 inference through the loop and the vmap
    emission and the MC-4 bs128 ELBO step through the loop, host wall ms
    (median of 3 after a warm-up), two profiled runs each (device busy ms,
    idle share, K-H's device ms) and the step's peak memory; then the INT8
    ``qresnet50`` (Flipout, calibrated on 3 x 32 images, conv+BN folded,
    uint8 activations) MC-10 bs128 batch the same way (K-F's rows and its
    Flipout epilogue's apart), its launches, the hash of its logits on
    fixed seeds (``int8_logits_digest``), the torch passes that the fused
    kernels replace (``int8_glue``) and the batch's perturbation GEMMs
    (``flipout_gemms``)."""
    import torch
    from torch import nn

    from bayesian_torch_tpu_torch.examples._engine import make_train_step
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_flipout_large,
    )
    from bayesian_torch_tpu_torch.models.bayesian.\
        quantized_resnet_flipout_large import qresnet50
    from bayesian_torch_tpu_torch.parallel import mc_forward

    gen = torch.Generator(device="cuda").manual_seed(7)

    def images(n=BATCH):
        return torch.randn(n, 3, IMAGE, IMAGE, generator=gen, device="cuda")

    tags = dict(kh=SIGN_TAG, kh3=QSIGN_TAG, kf="qmatmul", kf_flip=KF_FLIP_TAG)

    def measure(what, fn, reps=3):
        walls = [wall_ms(fn) for _ in range(reps + 1)][1:]
        report(out, "flipout", what, walls,
               [window(fn, tags) for _ in range(2)])

    model = resnet_flipout_large.resnet50(
        num_classes=1000, generator=torch.Generator().manual_seed(8),
        device="cuda")
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.bfloat16
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.momentum = None
    model.train()
    with torch.no_grad():
        model(images())
    for m in bns:
        m.momentum = 0.1
    model.eval()
    x = images()
    for emission in ("scan", "vmap"):
        def infer():
            with torch.no_grad():
                mc_forward(model, x, S, reduce="mean", return_kl=False,
                           emission=emission)
        measure(f"Flipout loop MC-{S} bs{BATCH}" if emission == "scan"
                else f"Flipout vmap MC-{S} bs{BATCH}", infer)
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(TRAIN_MC, BATCH, emission="scan")
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")

    def train():
        step(model, opt, x, y)

    train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    measure(f"Flipout loop MC-{TRAIN_MC} bs{BATCH} ELBO step", train)
    out[-1]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[flipout] peak {out[-1]['peak_gib']:.2f} GiB", flush=True)
    del model, opt, step
    torch.cuda.empty_cache()

    def calibrate(m):
        prepared = [v for v in m.modules()
                    if getattr(v, "quant_prepare", False)]
        for v in prepared:
            v.quant_prepare = False
        bn = [v for v in m.modules() if isinstance(v, nn.BatchNorm2d)]
        for v in bn:
            v.momentum = None
        m.train()
        with torch.no_grad():
            m(images(32))
        for v in bn:
            v.momentum = 0.1
        m.eval()
        for v in prepared:
            v.quant_prepare = True
        with torch.no_grad():
            for _ in range(3):
                m(images(32))

    qmodel = qresnet50(generator=torch.Generator().manual_seed(9),
                       device="cuda", calibrate=calibrate,
                       fuse_conv_bn=True, quantize_activations=True)

    def qinfer():
        with torch.no_grad():
            mc_forward(qmodel, x, S, reduce="mean", return_kl=False)

    measure(f"INT8 Flipout qresnet50 MC-{S} bs{BATCH}", qinfer)
    glue = int8_glue(qmodel, x)
    out[-1].update(glue, launches=int8_launches(qinfer),
                   logits_sha256=int8_logits_digest(qmodel, x))
    print(f"[flipout] INT8 batch: launches {out[-1]['launches']}, logits "
          f"sha256 {out[-1]['logits_sha256']}, the torch passes alone "
          f"{glue}", flush=True)
    del qmodel
    torch.cuda.empty_cache()
    flipout_gemms(out)


def int8_launches(fn):
    """K-F's (plain and with the Flipout epilogue) and K-H3's launches in
    one call of ``fn``."""
    from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh
    from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kfm

    wrappers = {"K-F": kfm.qmatmul_requant, "K-H3": kh.qsign_mul,
                "K-F flipout": getattr(kfm, "qmatmul_requant_flipout", None)}
    before = {k: getattr(f, "launches", 0) for k, f in wrappers.items()}
    fn()
    return {k: getattr(f, "launches", 0) - before[k]
            for k, f in wrappers.items()}


def int8_logits_digest(qmodel, x):
    """SHA-256 of an MC-10 batch's stacked logits (each draw's head
    output, the uint8 dequantized one to one) with every layer's generator
    reseeded: equal in two checkouts exactly when their INT8 Flipout paths
    give the same bits."""
    import hashlib

    import torch

    from bayesian_torch_tpu_torch.parallel import mc_forward

    gens = {id(m.generator): m.generator for m in qmodel.modules()
            if isinstance(getattr(m, "generator", None), torch.Generator)}
    for i, g in enumerate(gens.values()):
        g.manual_seed(1234 + i)
    with torch.no_grad():
        logits = mc_forward(qmodel, x, S, return_kl=False)
    return hashlib.sha256(logits.float().cpu().numpy().tobytes()).hexdigest()


def graph(out):
    """The eval MC-10 batch of the benchmark's two prediction cells
    (ResNet-50 bf16 NHWC: Reparameterization at bs128, Flipout at bs256)
    eager and replayed from its CUDA graph (``parallel/mc_graph.py``; a
    checkout without it times eager alone): the host's issue and the wall
    ms a batch, the device busy ms, idle share and rows of a profiled
    batch, the eager call's peak allocation against the graph pool's
    reserved bytes, the capture's ms, the key's us, and whether three
    replayed batches equal three eager ones bit for bit."""
    import torch

    from bayesian_torch_tpu_torch.parallel import mc as tmc
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_flipout_large, resnet_variational_large)

    try:
        from bayesian_torch_tpu_torch.parallel import mc_graph
    except ImportError:
        mc_graph = None
    gen = torch.Generator(device="cuda").manual_seed(6)
    for factory, batch in ((resnet_variational_large.resnet50, BATCH),
                           (resnet_flipout_large.resnet50, 2 * BATCH)):
        model = factory(num_classes=1000, device="cuda", data_format="NHWC",
                        generator=torch.Generator().manual_seed(5)).eval()
        for mod in model.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.bfloat16
        xs = [torch.randn(batch, IMAGE, IMAGE, 3, generator=gen,
                          device="cuda") for _ in range(3)]
        what = f"{model.conv1.estimator} MC-{S} bs{batch}"

        def call(j=0):
            return tmc.mc_forward(model, xs[j % 3], S, reduce="mean")

        def timed(n):
            issue, wall = [], []
            for j in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(j)
                issue.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(issue), statistics.median(wall)

        def profiled():
            torch.cuda.synchronize()
            with device_trace() as prof:
                call()
                torch.cuda.synchronize()
            rows = device_rows(prof)
            return dict(busy_ms=busy_ms(rows), rows=len(rows))

        r = dict(path=what)
        engages = mc_graph.engages if mc_graph else None
        if mc_graph:
            mc_graph.engages = lambda *a, **k: False
        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        r["eager_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        r["eager_issue_ms"], r["eager_wall_ms"] = timed(6)
        r["eager_profiled"] = profiled()
        if mc_graph:
            mc_graph.engages = engages
            mc_graph.reset()
            state = model.conv1.generator.get_state()
            call(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(1)
            torch.cuda.synchronize()
            r["capture_ms"] = (time.perf_counter() - t0) * 1e3
            got = [call(2)]
            pools = collections.Counter()
            for seg in torch.cuda.memory_snapshot():
                pools[tuple(seg.get("segment_pool_id", (0, 0)))] += \
                    seg["total_size"]
            r["pool_reserved_bytes"] = sum(
                n for k, n in pools.items() if k != (0, 0))
            r["reserved_bytes"] = torch.cuda.memory_reserved()
            mods = list(model.modules())
            keys = []
            for _ in range(20):
                t0 = time.perf_counter()
                mc_graph.key(mods, xs[0], (S, "mean", True))
                keys.append((time.perf_counter() - t0) * 1e6)
            r["key_us"] = statistics.median(keys)
            r["graph_issue_ms"], r["graph_wall_ms"] = timed(6)
            r["graph_profiled"] = profiled()
            model.conv1.generator.set_state(state)
            got = [call(j) for j in range(3)]
            mc_graph.engages = lambda *a, **k: False
            model.conv1.generator.set_state(state)
            want = [call(j) for j in range(3)]
            mc_graph.engages = engages
            r["equal"] = all(torch.equal(a, b) for g, w in zip(got, want)
                             for a, b in zip(g, w))
        print(f"[graph] {what}: " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items() if k != "path"), flush=True)
        out.append(r)
        del model, xs
        torch.cuda.empty_cache()


SECTIONS = dict(sampler=sampler, sampled=sampled, windowed=windowed,
                paths=paths, kg=kg_sites, kg_cl=kg_cl_sites, probe=probe,
                kf=kf, nhwc=nhwc_dot, signs=signs, flipout=flipout,
                graph=graph)


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--sections", nargs="+", choices=sorted(SECTIONS),
                        default=list(SECTIONS),
                        help="sections to run (default: all); a subset "
                        "keeps a run of two checkouts in turns within one "
                        "chip call's time limit")
    args = parser.parse_args(argv)
    label = args.label
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    sys.path.insert(0, os.getcwd())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[{label}] {card}", flush=True)
    rows, sums = {}, {}
    for name, section in SECTIONS.items():
        if name not in args.sections:
            continue
        rows[name] = []
        total = section(rows[name])
        if total is not None:
            sums[name] = total
    if "sampler" in rows:
        sums["rank"] = rank(rows)
    print(json.dumps(dict(label=label, card=card, sums=sums, rows=rows)),
          flush=True)


if __name__ == "__main__":
    main()
