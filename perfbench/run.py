"""The benchmark of ``bayesian_torch_tpu_torch``: one cell, one run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the weights and a ring of inputs from the seed on the card,
builds the configuration's model, and runs the cell's warm-up (a
training cell: its first ELBO steps, which the comparison follows). The
window then drives the cell's call in a closed loop for ``--seconds``:
each batch or step is issued when the previous one has completed on the
card. With ``--trace 1`` a few units inside the window run under
``torch.profiler`` and the run reports the cell's per-layer metrics;
otherwise its end-to-end metrics. Once the window has closed and the
program's state is freed, the plain reference (``reference/``) checks
what the window produced.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), and last ``checks``, each compared number beside its
limit, which also close standard error.

A cell on more than one chip starts one process a card
(``launch.py``); the first rank prints.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the printing process
FORBIDDEN = ("jax", "jaxlib", "flax", "bayesian_torch_tpu")
# set only by the CPU rehearsals of the tests: run on the CPU, no card
REHEARSE_ENV = "PERFBENCH_REHEARSE_ON_CPU"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths (the kernels' library itself goes to the package's own
    ``_build/``)."""
    cache = root / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_loaded() -> list:
    return sorted({name.partition(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Clock:
    """Times one unit: CUDA events on a card (the unit starts on an
    empty stream, so the first event marks its issue), the host's clock
    on the CPU."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        if self.cuda:
            self.start.record()
        else:
            self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t) * 1e3
        return False


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        rank: int = 0, world: int = 1):
    """One run of ``cell`` on this rank; the result (rank 0) or None."""
    import torch
    import torch.distributed as dist

    from perfbench import (correct, spec, system, traffic as traffic_mod,
                           weights, trace as trace_mod)

    cfg, mix_params = cell.config, cell.traffic
    arch = spec.function(cfg["shapes"])(cfg)
    mode = mix_params["mode"]
    num_mc, batch = mix_params["num_mc"], mix_params["batch"]
    flipout = cfg["estimator"] == "Flipout"
    if device.type == "cuda":
        torch.cuda.set_device(device)

    mesh, ctl = None, None
    if world > 1:
        mesh = system.mesh_for(cell.mesh)
        ctl = dist.new_group(backend="gloo")

    # --- set-up ----------------------------------------------------------
    log(f"set-up: imports and the device {time.time() - t0:.3f} s")
    system.apply_settings(cell.settings)
    w0 = weights.make(arch, cfg, seed, device)
    gen = torch.Generator().manual_seed(weights.mix(seed, "draws"))
    model = system.build(cfg, arch, w0, gen, device, cell.build)
    gen.manual_seed(weights.mix(seed, "draws"))
    del w0
    ring = traffic_mod.ring(cfg, mix_params, seed, device, rank, world)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"set-up: weights, model and inputs {time.time() - t0:.3f} s")
    calls = 0
    record = {}
    if mode == "predict":
        call = system.predict_call(model, num_mc, cell.call, mesh)

        def unit(j):
            return call(ring[j % len(ring)][0])
        with torch.no_grad():
            for j in range(mix_params["warmup"]):
                unit(j)
                calls += 1
    else:
        step, opt = system.train_call(model, num_mc, batch,
                                      mix_params["lr"],
                                      mix_params["momentum"], cell.call,
                                      mesh)

        def unit(j):
            x, y = ring[j % len(ring)]
            return step(x, y)
        params = dict(model.named_parameters())
        losses = []
        for j in range(mix_params["check_steps"]):
            loss, _, _ = unit(j)
            losses.append(float(loss))
            calls += 1
            if j == 0:
                record["grad1"] = {k: _buffer_norm(opt, p)
                                   for k, p in params.items()}
        record["loss"] = losses
        w_init = weights.make(arch, cfg, seed, device)
        record["change"] = _changes(arch, params, w_init, system)
        record["running"] = {
            name: (model.get_submodule(name).running_mean.detach()
                   .cpu().clone(),
                   model.get_submodule(name).running_var.detach()
                   .cpu().clone())
            for name in arch.bn_names}
        del w_init
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if ctl is not None:
        dist.barrier(group=ctl)
    setup_s = time.time() - t0
    log(f"set-up {setup_s:.3f} s")

    # --- the window -------------------------------------------------------
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    classes = spec.KernelClasses(cell.root)
    kept, keep_k = [], mix_params.get("checked", 0)
    sampler = random.Random(weights.mix(seed, "sample"))
    lat, host = [], []
    collector = _GcClock()
    i = 0
    start = time.perf_counter()
    gc.callbacks.append(collector)
    while True:
        issue = time.perf_counter()
        with Clock(device) as clock:
            out = unit(calls)
            host.append((time.perf_counter() - issue) * 1e3)
        lat.append(clock.ms)
        if mode == "predict" and keep_k:
            # a uniform sample of the window's answers (reservoir)
            if len(kept) < keep_k:
                kept.append((calls, out))
            else:
                at = sampler.randrange(i + 1)
                if at < keep_k:
                    kept[at] = (calls, out)
        del out
        calls += 1
        i += 1
        done = time.perf_counter() - start >= seconds
        if ctl is not None:
            flag = torch.tensor([int(done)])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ctl)
            done = bool(flag.item())
        if done:
            break
    window_s = time.perf_counter() - start
    gc.callbacks.remove(collector)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    units = i

    # --- the traced units, after the window --------------------------------
    summary = None
    if trace:
        # the card's activity alone, for busy time, classes and launches
        # (tracing the host's operations too would slow the host and read
        # as idle device time); then one unit with the host's operations,
        # to name what the host did in the card's idle gaps
        n = mix_params["traced"]
        summary, calls = _traced(unit, calls, n, False, classes, device)
        labelled, calls = _traced(unit, calls, 1, True, classes, device)
        summary["idle_gaps"] = labelled["idle_gaps"]

    # --- the ranks' numbers -----------------------------------------------
    mine = {"peak": peak, "summary": summary}
    if ctl is not None:
        everyone = [None] * world
        dist.all_gather_object(everyone, mine, group=ctl)
    else:
        everyone = [mine]
    if rank != 0:
        return None
    peak = max(m["peak"] for m in everyone)
    if summary is not None:
        summary = trace_mod.merge([m["summary"] for m in everyone])

    # --- free the program's state, then the comparison --------------------
    del model, unit, ring
    if mode == "train":
        del step, opt, params
    else:
        del call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = cell.workload["limits"]
    if mode == "predict":
        numbers, failed = _check_predict(cell, arch, seed, device, kept,
                                          num_mc, flipout)
    else:
        numbers = _check_train(cell, arch, seed, device, record, num_mc,
                               batch)
        failed = 0
    ok = correct.verdict(numbers, limits)
    if mode == "train":
        failed = sum(1 for k, v in limits.items()
                     if not numbers.get(k, math.inf) <= v)

    # --- the metrics -------------------------------------------------------
    ctx = {"mode": mode, "arch": arch, "cfg": cfg, "traffic": mix_params,
           "batch": batch, "num_mc": num_mc, "chips": world,
           "window": {"seconds": window_s, "units": units}}
    if trace:
        ctx["summary"] = summary
        wanted = cell.metrics("per_layer")
    else:
        ctx.update(images=units * batch, seconds=window_s, latencies_ms=lat,
                   peak_bytes=peak, setup_s=setup_s)
        wanted = cell.metrics("end_to_end")
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"], cell.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": world, "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": units, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        log(f"kernels in no class: {summary['unclassed']}")
    result["checks"] = correct.checks_line(numbers, limits)
    log(f"window {window_s:.3f} s, {units} units, latency ms: "
        f"{_spread(lat)}; the host's issue of a unit, ms: {_spread(host)}; "
        f"garbage collection {collector.ms:.1f} ms in "
        f"{collector.runs} runs; {torch.get_num_threads()} threads")
    slow = sorted(range(len(lat)), key=lat.__getitem__)[-5:]
    log("the slowest units (unit: latency ms, host issue ms): "
        + ", ".join(f"{j}: {lat[j]:.1f}, {host[j]:.1f}" for j in slow))
    return result


def _spread(values) -> str:
    q = (statistics.quantiles(values, n=4) if len(values) > 1
         else values * 3)
    return (f"min {min(values):.3f} quartiles {q[0]:.3f} {q[1]:.3f} "
            f"{q[2]:.3f} max {max(values):.3f}")


class _GcClock:
    """A ``gc.callbacks`` entry: the collector's runs and time."""

    def __init__(self):
        self.ms, self.runs, self._t = 0.0, 0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self.runs += 1


def _traced(unit, calls, n, host, classes, device):
    """``n`` units under the profiler, each issued when the last has
    completed, as in the window: (their summary, the next call)."""
    import torch

    from perfbench import trace as trace_mod

    with trace_mod.profiled(host) as prof:
        t = time.perf_counter()
        for _ in range(n):
            with torch.autograd.profiler.record_function("perfbench.unit"):
                unit(calls)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            calls += 1
        seconds = time.perf_counter() - t
    return trace_mod.summarize(prof, classes, n, seconds), calls


def _buffer_norm(opt, p) -> float:
    """The norm of the gradient SGD holds for ``p`` after its first step
    (its momentum buffer; 0 where it holds none)."""
    buf = opt.state.get(p, {}).get("momentum_buffer")
    return 0.0 if buf is None else float(buf.double().norm())


def _changes(arch, params, w_init, system):
    """Each leaf's change from the benchmark's weights, by norm."""
    out = {}
    with_names = {}
    for layer in arch.layers:
        for key, t in w_init["layers"][layer.name].items():
            with_names[system.param_name(layer, key)] = t
    for name, p in w_init["bn"].items():
        for key in ("weight", "bias"):
            with_names[f"{name}.{key}"] = p[key]
    for name, before in with_names.items():
        out[name] = float((params[name].detach().double()
                           - before.double()).norm())
    return out


def _check_predict(cell, arch, seed, device, kept, num_mc, flipout):
    """The sampled answers against the reference: (numbers, answers that
    failed)."""
    import torch

    from perfbench import correct, spec, traffic as traffic_mod, weights

    cfg = cell.config
    ref = spec.reference(cell)
    ref.strict_float32()
    w = weights.make(arch, cfg, seed, device)
    gen = torch.Generator().manual_seed(weights.mix(seed, "draws"))
    wanted = {c for c, _ in kept}
    plans, c = {}, 0
    while wanted - set(plans):
        plan = ref.infer_plan(arch, gen, num_mc, flipout)
        if c in wanted:
            plans[c] = plan
        c += 1
    gaps, kl_gap, failed = [], 0.0, 0
    limit = cell.workload["limits"]["mean_gap"]
    ring = cell.traffic["ring"]
    for c, (mean, kl) in sorted(kept, key=lambda t: t[0]):
        x, _ = traffic_mod.slot(cfg, cell.traffic, seed, c % ring, device)
        want, kl_ref = ref.infer_mean(arch, cfg, w, x, plans[c], num_mc,
                                      flipout)
        gap = correct.rel_norm_gap(mean.float(), want) \
            if correct.finite(mean) else math.inf
        gaps.append(gap)
        failed += not gap <= limit
        kl_gap = max(kl_gap, correct.rel_gap(float(kl), kl_ref))
        log(f"checked batch {c}: mean_gap {gap:.6g}")
        del x, want
    return {"mean_gap": max(gaps), "kl_gap": kl_gap}, failed


def _check_train(cell, arch, seed, device, record, num_mc, batch):
    """The set-up's first steps against the reference's."""
    import torch

    from perfbench import correct, spec, traffic as traffic_mod, weights

    cfg, mix_params = cell.config, cell.traffic
    ref = spec.reference(cell)
    ref.strict_float32()
    n = mix_params["check_steps"]
    w = weights.make(arch, cfg, seed, device)
    gen = torch.Generator().manual_seed(weights.mix(seed, "draws"))
    plans = [ref.train_plan(arch, gen) for _ in range(n)]
    batches = [traffic_mod.slot(cfg, mix_params, seed, j, device)
               for j in range(n)]
    out = ref.train_steps(arch, cfg, w, batches, plans, num_mc, batch,
                          mix_params["lr"], mix_params["momentum"])
    want = reference_readings(arch, w, out)
    got = {"loss": record["loss"], "grad": record["grad1"],
           "change": record["change"],
           "running": running_changes(w, record["running"])}
    log(f"losses {got['loss']} reference {want['loss']}")
    keep = correct.moving_leaves(want["grad"])
    for what in ("grad", "change", "running"):
        groups = (("", None),) if what == "running" else [
            (g, {k for k in keep if correct.group(k) == g})
            for g in correct.GROUPS]
        for name, kept in groups:
            for row in correct.worst_leaves(got[what], want[what], kept, 2):
                log(f"{what} {name} leaf {row[1]}: gap {row[0]:.4g}, norm "
                    f"{row[2]:.6g}, reference {row[3]:.6g}")
    numbers = correct.train_numbers(got, want)
    for name, value in numbers.items():
        log(f"reading {name} {value!r}")
    return numbers


def running_changes(w, running: dict) -> dict:
    """Each BatchNorm running statistic's change from the benchmark's
    values, by norm, under the program's buffer names."""
    out = {}
    for name, (rm, rv) in running.items():
        init = w["bn"][name]
        for key, after in (("running_mean", rm), ("running_var", rv)):
            out[f"{name}.{key}"] = float(
                (after.double() - init[key].double().cpu()).norm())
    return out


def reference_readings(arch, w, out) -> dict:
    """The reference's steps (``train_steps``) as ``train_numbers``
    reads them, under the program's leaf names."""
    from perfbench import correct, system

    names = _leaf_names(arch, system)
    before = {}
    for layer in arch.layers:
        for key, t in w["layers"][layer.name].items():
            before[f"{layer.name}.{key}"] = t
    for name, p in w["bn"].items():
        for key in ("weight", "bias"):
            before[f"{name}.{key}"] = p[key]
    return {
        "loss": out["loss"],
        "grad": {names[k]: v for k, v in
                 correct.norms(out["grad1"]).items()},
        "change": {names[k]: v for k, v in
                   correct.leaf_change(out["params"], before).items()},
        "running": running_changes(w, out["running"])}


def _leaf_names(arch, system):
    """The program's name of each reference leaf."""
    out = {}
    for layer in arch.layers:
        keys = ("mu", "rho") + (("mu_bias", "rho_bias") if layer.bias
                                else ())
        for key in keys:
            out[f"{layer.name}.{key}"] = system.param_name(layer, key)
    for name in arch.bn_names:
        for key in ("weight", "bias"):
            out[f"{name}.{key}"] = f"{name}.{key}"
    return out


def emit(result) -> None:
    for name, check in result["checks"].items():
        log(f"check {name} {check['value']!r} limit {check['limit']!r}")
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    import torch

    from perfbench import spec

    cell = spec.Cell(args.workload)
    rehearse = os.environ.get(REHEARSE_ENV) == "1"
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    t0 = float(os.environ.get("PERFBENCH_T0", T0))
    if not rehearse and not (torch.cuda.is_available()
                             and torch.cuda.device_count() >= cell.chips):
        log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if cell.chips > 1 and world == 1:
        from perfbench import launch

        code, line = launch.launch(
            cell.chips, sys.argv[1:] if argv is None else argv, T0)
        found = forbidden_loaded()
        if code or found:
            if found:
                log(f"modules that the benchmark may not load: {found}")
            return code or 3
        print(line, flush=True)
        return 0
    if rehearse:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    result = run(cell, args.seed, args.seconds, bool(args.trace), device, t0,
                 rank, world)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if result is None:
        return 0
    found = forbidden_loaded()
    if found:
        log(f"modules that the benchmark may not load: {found}")
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
