"""Finding a cell's files by name.

``BENCHMARK.json`` names the cells, configurations, traffic mixes and
metrics; each lives in a file of its own under ``perfbench/``, found from
its name alone, so that a later change adds a cell, a configuration, a
mix, a metric or a kernel class as a new file and edits none:

- ``configs/<config>.json``: the file that BENCHMARK.json's ``file`` names;
  it names the function that describes its shapes (``shapes``) and its
  plain reference's module (``reference``);
- ``workloads/<cell>.json``: the limits of the cell's comparison
  (``limits``) and what the cell sets of the program, each passed through
  unchanged (``system.py``): ``settings``, ``build``, ``entry`` and, on
  several chips, ``mesh``; ``reference`` where its plain reference is not
  the configuration's;
- ``traffic/<traffic>.json``: the parameters the generator reads;
- ``metrics/<metric>.py``: a reader with ``read(ctx)`` returning the
  metric's value, or None where the cell gives it nothing to read; a
  metric with no file of its own reads with that of its name less the
  last dotted part (``mfu.train.dp4`` with ``mfu.train.py``);
- ``kernel_classes/<class>.json``: a layer's kernel-name patterns.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


class Cell:
    """One cell with everything it is run from."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.bench = benchmark(root)
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.name = name
        here = root / "perfbench"
        self.workload = load_json(here / "workloads" / f"{name}.json")
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(here / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        # what the cell sets of the program (system.py)
        self.settings = self.workload.get("settings", {})
        self.build = self.workload.get("build", {})
        self.call = self.workload.get("entry", {})
        self.mesh = self.workload.get("mesh", {"data": self.chips})

    def metrics(self, kind: str) -> list:
        """The entries of ``kind`` ('end_to_end' or 'per_layer') that this
        cell reports, in BENCHMARK.json's order."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def function(path: str):
    """The function ``module:name`` (a configuration's ``shapes``)."""
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def reference(cell: "Cell"):
    """The plain reference module of a cell: the one its workload file
    names (a cell whose entry draws its weights in another order than
    the configuration's reference follows), else its configuration's."""
    return importlib.import_module(
        cell.workload.get("reference", cell.config["reference"]))


def reader_path(name: str, root: Path = ROOT) -> Path:
    """``metrics/<name>.py``, or where there is none, that of the name
    less its last dotted part, and so on."""
    here = root / "perfbench" / "metrics"
    stem = name
    while not (here / f"{stem}.py").exists() and "." in stem:
        stem = stem.rpartition(".")[0]
    return here / f"{stem}.py"


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of the metric's file (``reader_path``)."""
    path = reader_path(name, root)
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class KernelClasses:
    """Kernel names to layers, from ``kernel_classes/*.json``: each file
    has a ``class``, a ``priority`` (lower is tried first) and regular
    expressions ``patterns`` searched in the name. A kernel that matches
    none is ``other``."""

    def __init__(self, root: Path = ROOT):
        entries = [load_json(p) for p in
                   sorted((root / "perfbench" / "kernel_classes")
                          .glob("*.json"))]
        entries.sort(key=lambda e: (e["priority"], e["class"]))
        self.classes = [(e["class"], [re.compile(p) for p in e["patterns"]])
                        for e in entries]
        self._cache = {}

    def __call__(self, kernel: str) -> str:
        found = self._cache.get(kernel)
        if found is None:
            found = next((cls for cls, pats in self.classes
                          if any(p.search(kernel) for p in pats)), "other")
            self._cache[kernel] = found
        return found
