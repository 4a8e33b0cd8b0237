"""The readings that a cell's limits are set from, apart from the sound
runs: the control and the faults, at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13

For each seed it makes the cell's weights and inputs as a run makes them
and puts the plain reference in the program's place:

- ``control``: the reference computed with float8 products (e4m3, a
  scale per tensor), the precision under the configuration's bfloat16,
  against the float32 reference; it has to fail one of the numbers;
- ``half``: a fault, half of the work left out and the mean taken over
  the rest: the MC mean over the first half of the draws (prediction), or
  the steps on the first half of the batch (training);
- ``unreduced`` (a cell on several chips): a fault, the exchange of
  gradients left out: the first rank steps with its rows' part of the
  gradient alone;
- ``bf16`` (training): not a limit's reading but a look, the reference
  with bfloat16 products, the configuration's own precision.

A step that leaves its state unchanged reads 1 in every ``change_*`` and
``grad_*`` number by their definition and needs no run; so does a
group's gradient left out (the noise scale's, BatchNorm's affine one) in
its group's numbers. Prints one JSON line a seed and reading.
The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def predict_readings(cell, arch, seed, device):
    import torch

    from perfbench import correct, spec, traffic, weights

    cfg, mix = cell.config, cell.traffic
    ref = spec.reference(cell)
    num_mc, flipout = mix["num_mc"], cfg["estimator"] == "Flipout"
    w = weights.make(arch, cfg, seed, device)
    gen = torch.Generator().manual_seed(weights.mix(seed, "draws"))
    plan = ref.infer_plan(arch, gen, num_mc, flipout)
    x, _ = traffic.slot(cfg, mix, seed, 0, device)
    want, kl = ref.infer_mean(arch, cfg, w, x, plan, num_mc, flipout)
    low, kl_low = ref.infer_mean(arch, cfg, w, x, plan, num_mc, flipout,
                                 q=ref.fp8)
    half, _ = ref.infer_mean(arch, cfg, w, x, plan, num_mc, flipout,
                             draws=range(num_mc // 2))
    return {
        "control": {"mean_gap": correct.rel_norm_gap(low, want),
                    "kl_gap": correct.rel_gap(kl_low, kl)},
        "half": {"mean_gap": correct.rel_norm_gap(half, want),
                 "kl_gap": 0.0}}


def _numbers(arch, w, got, want):
    """Every training number of reading ``got`` against ``want`` (both
    ``train_steps`` results)."""
    from perfbench import correct
    from perfbench.run import reference_readings

    return correct.train_numbers(reference_readings(arch, w, got),
                                 reference_readings(arch, w, want))


def train_readings(cell, arch, seed, device):
    import torch

    from perfbench import spec, traffic, weights

    cfg, mix = cell.config, cell.traffic
    ref = spec.reference(cell)
    n, num_mc, batch = mix["check_steps"], mix["num_mc"], mix["batch"]
    w = weights.make(arch, cfg, seed, device)
    gen = torch.Generator().manual_seed(weights.mix(seed, "draws"))
    plans = [ref.train_plan(arch, gen) for _ in range(n)]
    batches = [traffic.slot(cfg, mix, seed, j, device) for j in range(n)]
    args = (num_mc, batch, mix["lr"], mix["momentum"])
    want = ref.train_steps(arch, cfg, w, batches, plans, *args)
    out = {"control": _numbers(arch, w, ref.train_steps(
        arch, cfg, w, batches, plans, *args, q=ref.fp8), want),
        "bf16": _numbers(arch, w, ref.train_steps(
            arch, cfg, w, batches, plans, *args, q=ref.bf16), want)}
    halves = [(x[:batch // 2], y[:batch // 2]) for x, y in batches]
    out["half"] = _numbers(arch, w, ref.train_steps(
        arch, cfg, w, halves, plans, *args), want)
    if cell.chips > 1:
        out["unreduced"] = _numbers(arch, w, ref.train_steps(
            arch, cfg, w, batches, plans, *args,
            grad_rows=batch // cell.chips), want)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from perfbench import spec

    cell = spec.Cell(args.workload)
    arch = spec.function(cell.config["shapes"])(cell.config)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    spec.reference(cell).strict_float32()
    readings = (predict_readings if cell.traffic["mode"] == "predict"
                else train_readings)
    for seed in args.seeds:
        t = time.time()
        for name, numbers in readings(cell, arch, seed, device).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, "numbers": numbers,
                              "seconds": round(time.time() - t, 1)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
