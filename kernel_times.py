"""Device times of the hand-written GEMM kernels K-G and K-F at Bayesian
ResNet-50's shapes, beside one PyTorch call for the same product.

    python3 kernel_times.py [--label NAME]

Imports ``bayesian_torch_tpu_torch`` from the current directory, so the
same script times two checkouts (a change and its parent, each unpacked
with ``git archive``) in turns on one card. Times are the kernel's own
device time per launch from ``torch.profiler`` over ``REPS`` back-to-back
launches after a warm-up (the wrapper's small torch ops, such as K-F's
column sums, are not counted); a library call counts all its device rows.
Needs a CUDA card; prints one line per shape and a JSON summary last.

- K-G (``ops/cuda/mc_gemm.py``), bf16, at the 12 pointwise sites of
  ResNet-50 (MC-10, batch 128): ``mc_gemm`` per draw, ``pointwise_gemm``
  with one weight over the B*S batch (the Flipout mean convs), and the
  input gradient ``mc_gemm(g, w^T)``; beside ``torch.matmul`` with the
  broadcast weight and the S-way grouped cuDNN conv. The matmul probe:
  ``matmul`` at 4096^3 and 8192 x 4096 x 4096, bf16 and int8.
- K-F (``ops/cuda/qmatmul.py``) at the 21 GEMM shapes of one INT8
  ``qresnet50`` forward at batch 128 (54 launches; the stem's K of 147
  widened to 160 as ``ops.int8.qconv`` does), beside ``torch._int_mm``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPS = 10
BATCH, S = 128, 10
HBM_BPS, BF16_OPS, INT8_OPS = 3.35e12, 989e12, 1979e12
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


def bound_ms(nbytes, ops, peak):
    return max(nbytes / HBM_BPS, ops / peak) * 1e3


def device_ms(fn, tag=None):
    """Device ms per call of ``fn``: the rows whose name holds ``tag``, or
    all rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profiler session now and then records no device activity at all
    # (seen once in a hundred on the H100 machine): take the next one
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        rows = [e for e in events if tag is None or tag in e.key]
        if rows:
            return sum(e.self_device_time_total for e in rows) / REPS / 1e3
        if events:
            break
    raise RuntimeError(f"no device rows{'' if tag is None else ' ' + tag}")


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
        row = dict(
            site=f"{ci}->{co}@{sp}", count=count,
            kg=device_ms(lambda: kg.mc_gemm(x4, w3), "mc_gemm"),
            kg_s1=device_ms(lambda: kg.pointwise_gemm(xs, w3[0]), "mc_gemm"),
            kg_dx=device_ms(lambda: kg.mc_gemm(g, wt), "mc_gemm"),
            matmul=device_ms(lambda: torch.matmul(w3, x4)),
            matmul_s1=device_ms(lambda: torch.matmul(w3[0], xs)),
            matmul_dx=device_ms(lambda: torch.matmul(wt, g)),
            cudnn=device_ms(lambda: F.conv2d(x, w, groups=S)),
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
            row = dict(shape=f"{M}x{K}x{N} {dtype}",
                       kg=device_ms(lambda: kg.matmul(a, b), "mc_gemm"),
                       lib=device_ms(lambda: lib(a, b)))
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
        row = dict(
            shape=f"{M}x{K}x{N}", count=count,
            kf=device_ms(lambda: kfm.qmatmul_requant(
                x, 0.02, 117, w, 0.01, b, 3.0, 128), "qmatmul"),
            int_mm=device_ms(lambda: torch._int_mm(xc, w.t())),
            bound=bound_ms(M * K + N * K + M * N + 8 * N, 2 * M * N * K,
                           INT8_OPS))
        print(f"[K-F] {row}", flush=True)
        out.append(row)
        for k in tot:
            tot[k] += count * row[k]
        del x, w, b, xc
    print(f"[K-F] sums over one forward's 54 GEMMs: {tot}", flush=True)
    return tot


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    label = parser.parse_args(argv).label
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    sys.path.insert(0, os.getcwd())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[{label}] {card}", flush=True)
    rows = dict(kg=[], probe=[], kf=[])
    sums = dict(kg=kg_sites(rows["kg"]))
    probe(rows["probe"])
    sums["kf"] = kf(rows["kf"])
    print(json.dumps(dict(label=label, card=card, sums=sums, rows=rows)),
          flush=True)


if __name__ == "__main__":
    main()
