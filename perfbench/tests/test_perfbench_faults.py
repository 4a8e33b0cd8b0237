"""The comparison that decides ``correct`` fails what it should.

Each test drives a whole run on the CPU (the harness's look for a card
skipped) of a narrow stand-in of a cell, held to that cell's own limits,
with the timed path broken underneath: an answer altered where it is
made, half of the work left out and the mean taken over the rest, a step
that leaves its state unchanged, one group of leaves' gradient left out
(the noise scale's, K-C's; BatchNorm's affine one), the exchange of
gradients between ranks left out. The same run unbroken comes out
correct. The control (the reference in the program's place with float8
products) fails the cell's limits too. The launcher is rehearsed with
two gloo ranks.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import arch as arch_mod, control, run, spec
from perfbench.tests import narrow

PREDICT = {"mode": "predict", "num_mc": 4, "batch": 4, "ring": 3,
           "warmup": 1, "traced": 1, "checked": 2}
TRAIN = {"mode": "train", "num_mc": 2, "batch": 8, "ring": 4,
         "check_steps": 3, "traced": 1, "lr": 0.01, "momentum": 0.9}


def _limits(cell):
    return spec.Cell(cell).workload["limits"]


def _cell(tmp_path, estimator, traffic, limits, chips=1):
    root = narrow.checkout(tmp_path, {"narrow": (
        narrow.config(estimator, "float32"), traffic, limits, chips)})
    return spec.Cell("narrow", root)


def _predict(tmp_path, estimator="Reparameterization"):
    cell = _cell(tmp_path, estimator, PREDICT,
                 _limits("bresnet50.infer.mc10"))
    return run.run(cell, 2**32 + 3, 0.1, False, torch.device("cpu"),
                   time.time())


def _train(tmp_path):
    cell = _cell(tmp_path, "Reparameterization", TRAIN,
                 _limits("bresnet50.train.mc4"))
    return run.run(cell, 11, 0.1, False, torch.device("cpu"), time.time())


def test_sound_prediction_is_correct(tmp_path):
    res = _predict(tmp_path)
    assert res["correct"] and res["failed"] == 0, res["checks"]


def _wrap_mc_forward(monkeypatch, change):
    from bayesian_torch_tpu_torch.parallel import mc

    inner = mc.mc_forward

    def broken(model, x, num_mc, **kw):
        return change(inner, model, x, num_mc, **kw)
    monkeypatch.setattr(mc, "mc_forward", broken)


def test_an_altered_answer_is_caught(tmp_path, monkeypatch):
    def swap_rows(inner, model, x, num_mc, **kw):
        mean, kl = inner(model, x, num_mc, **kw)
        return mean[[1, 0] + list(range(2, mean.shape[0]))], kl
    _wrap_mc_forward(monkeypatch, swap_rows)
    res = _predict(tmp_path)
    assert not res["correct"] and res["failed"] > 0, res["checks"]


def test_half_the_draws_is_caught(tmp_path, monkeypatch):
    def half(inner, model, x, num_mc, **kw):
        return inner(model, x, num_mc // 2, **kw)
    _wrap_mc_forward(monkeypatch, half)
    res = _predict(tmp_path, "Flipout")
    assert not res["correct"], res["checks"]


def test_sound_training_is_correct(tmp_path):
    res = _train(tmp_path)
    assert res["correct"], res["checks"]


def test_a_step_that_changes_nothing_is_caught(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step",
                        lambda self, closure=None: None)
    res = _train(tmp_path)
    assert not res["correct"], res["checks"]
    assert res["checks"]["change_mu_median_gap"]["value"] > 0.9


def test_the_noise_scale_gradient_left_out_is_caught(tmp_path, monkeypatch):
    """K-C's gradient of the noise scale returns zeros: rho moves by the
    KL alone."""
    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights

    calls = []

    def zero(seed, g, **kw):
        calls.append(g.shape)
        return torch.zeros(g.shape[1:], dtype=g.dtype)
    monkeypatch.setattr(sampled_weights, "dsigma", zero)
    res = _train(tmp_path)
    assert calls and not res["correct"], res["checks"]
    assert res["checks"]["grad_rho_median_gap"]["value"] > 0.5
    assert res["checks"]["grad_mu_median_gap"]["value"] < 0.01


def test_batchnorm_affine_gradient_left_out_is_caught(tmp_path,
                                                      monkeypatch):
    from perfbench import system

    inner = system.train_call

    def broken(model, *args, **kw):
        for m in model.modules():
            if "BatchNorm" in type(m).__name__:
                for p in m.parameters(recurse=False):
                    p.register_hook(torch.zeros_like)
        return inner(model, *args, **kw)
    monkeypatch.setattr(system, "train_call", broken)
    res = _train(tmp_path)
    assert not res["correct"], res["checks"]
    assert res["checks"]["change_bn_median_gap"]["value"] > 0.5


def test_half_the_batch_is_caught(tmp_path, monkeypatch):
    from bayesian_torch_tpu_torch.examples import _engine

    inner = _engine.make_train_step

    def make(num_mc, batch_size, **kw):
        step = inner(num_mc, batch_size, **kw)

        def half(model, opt, x, y):
            n = x.shape[0] // 2
            return step(model, opt, x[:n], y[:n])
        return half
    monkeypatch.setattr(_engine, "make_train_step", make)
    res = _train(tmp_path)
    assert not res["correct"], res["checks"]


def _rank(rank, root, port, unreduced, out):
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if unreduced:
        from bayesian_torch_tpu_torch.examples import _engine
        _engine.reduce_gradients = lambda model, mesh: None
    res = run.run(spec.Cell("narrow", root), 11, 0.1, False,
                  torch.device("cpu"), time.time(), rank, 2)
    import torch.distributed as dist
    dist.destroy_process_group()
    if res is not None:
        with open(out, "w") as fh:
            json.dump(res, fh)


@pytest.mark.parametrize("unreduced", [False, True])
def test_the_exchange_between_ranks(tmp_path, unreduced):
    """Two gloo ranks of a data-parallel step: correct as they are, and
    not correct with the gradients' all-reduce left out."""
    from perfbench.launch import free_port

    cell = _cell(tmp_path, "Reparameterization", TRAIN,
                 _limits("bresnet50.train.mc4"), chips=2)
    out = tmp_path / "result.json"
    torch.multiprocessing.start_processes(
        _rank, args=(cell.root, free_port(), unreduced, str(out)),
        nprocs=2, start_method="spawn")
    res = json.loads(out.read_text())
    assert res["correct"] != unreduced, res["checks"]


def test_the_launcher_rehearsed_on_two_gloo_ranks(tmp_path):
    cell = _cell(tmp_path, "Reparameterization", TRAIN,
                 _limits("bresnet50.train.mc4"), chips=2)
    env = dict(os.environ, PERFBENCH_REHEARSE_ON_CPU="1",
               PYTHONPATH=str(narrow.REPO))
    proc = subprocess.run(
        [sys.executable, str(cell.root / "perfbench/run.py"), "--workload",
         "narrow", "--seed", str(2**31 + 9), "--seconds", "0.1", "--trace",
         "1"], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["device"]["count"] == 2
    assert "breakdown" in line
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


def test_no_result_without_a_card(tmp_path):
    cell = _cell(tmp_path, "Reparameterization", PREDICT,
                 _limits("bresnet50.infer.mc10"))
    env = {k: v for k, v in os.environ.items()
           if k != "PERFBENCH_REHEARSE_ON_CPU"}
    env["PYTHONPATH"] = str(narrow.REPO)
    proc = subprocess.run(
        [sys.executable, str(cell.root / "perfbench/run.py"), "--workload",
         "narrow", "--seed", "1", "--seconds", "1", "--trace", "0"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """A directory of BENCHMARK.json and perfbench/ alone."""
    root = narrow.checkout(tmp_path, {})
    env = dict(os.environ, PERFBENCH_REHEARSE_ON_CPU="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(root / "perfbench/run.py"), "--workload",
         "bresnet50.infer.mc10", "--seed", "1", "--seconds", "1",
         "--trace", "0"], env=env, capture_output=True, text=True,
        timeout=300, cwd=root)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell,estimator,traffic", [
    ("bresnet50.infer.mc10", "Reparameterization", PREDICT),
    ("bresnet50_flipout.infer.mc10", "Flipout", PREDICT),
    ("bresnet50.train.mc4", "Reparameterization", TRAIN)])
def test_the_control_fails(tmp_path, cell, estimator, traffic):
    """The reference with float8 products, in the program's place, at a
    size a test holds: it fails one of the cell's limits."""
    limits = _limits(cell)
    c = _cell(tmp_path, estimator, traffic, limits)
    c.config["compute_dtype"] = "bfloat16"
    readings = (control.predict_readings if traffic["mode"] == "predict"
                else control.train_readings)(
        c, arch_mod.resnet(c.config), 3, torch.device("cpu"))
    numbers = readings["control"]
    assert any(numbers[k] > v for k, v in limits.items()), numbers
