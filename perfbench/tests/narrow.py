"""Narrow stand-ins of the benchmark's configurations for the CPU tests:
the port's ResNet with one bottleneck a stage, built by the same class
the ResNet-50 factories build, and a temporary checkout that holds them
beside the benchmark's own files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _resnet(estimator, **kw):
    from bayesian_torch_tpu_torch.models._large_resnet import (Bottleneck,
                                                                LargeResNet)

    return LargeResNet(Bottleneck, [1, 1, 1, 1], estimator=estimator, **kw)


def reparameterization(**kw):
    return _resnet("Reparameterization", **kw)


def flipout(**kw):
    return _resnet("Flipout", **kw)


def config(estimator="Reparameterization", compute_dtype="float32"):
    cfg = json.loads((REPO / "perfbench/configs/bayesian_resnet50.json")
                     .read_text())
    cfg.update(layers=[1, 1, 1, 1], num_classes=10, image_size=64,
               compute_dtype=compute_dtype, estimator=estimator,
               factory="perfbench.tests.narrow:" + (
                   "flipout" if estimator == "Flipout"
                   else "reparameterization"))
    return cfg


def checkout(tmp: Path, cells: dict) -> Path:
    """A checkout at ``tmp`` with the benchmark's files and ``cells``:
    {name: (config dict, traffic dict, limits, chips[, workload's other
    keys])}, each written as new files, and a BENCHMARK.json that names
    them. A prediction's entry defaults to ``reduce="mean"``."""
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (cfg, traffic, limits, chips, *extra) in cells.items():
        (tmp / f"perfbench/configs/{name}.json").write_text(json.dumps(cfg))
        (tmp / f"perfbench/traffic/{name}.json").write_text(
            json.dumps(traffic))
        workload = {"entry": {"reduce": "mean"}
                    if traffic["mode"] == "predict" else {}}
        workload.update(*extra, limits=limits)
        (tmp / f"perfbench/workloads/{name}.json").write_text(
            json.dumps(workload))
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": ["layers", "num_classes",
                                             "image_size"],
                                 "why": "a narrow stand-in for the tests"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": name, "chips": chips,
                                   "why": "a narrow stand-in"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
