"""BENCHMARK.json and the files it names: every cell resolves its files
by name, every name and unit keeps to its alphabet, every per-layer
metric's cells report the metric it moves, nothing the benchmark runs
loads JAX or the JAX package, and a new cell comes as new files."""

from __future__ import annotations

import ast
import hashlib
import json
import re
import time
from pathlib import Path

import pytest
import torch

from perfbench import arch as arch_mod, correct, roofline, run, spec
from perfbench.tests import narrow

REPO = narrow.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "bayesian_torch_tpu"}
TRAIN_NUMBERS = ({"loss_gap", "running_gap", "running_median_gap"}
                 | {f"{k}_{g}{m}gap" for k in ("grad", "change")
                    for g in ("",) + tuple(f"{x}_" for x in correct.GROUPS)
                    for m in ("", "median_")})
WORKLOAD_KEYS = {"limits", "entry", "build", "settings", "mesh", "reference"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files(cell):
    c = spec.Cell(cell)
    assert c.config["reduced"] == c.config_entry["reduced"]
    assert c.traffic["mode"] in ("predict", "train")
    names = ({"mean_gap", "kl_gap"} if c.traffic["mode"] == "predict"
             else TRAIN_NUMBERS)
    assert c.workload["limits"] and set(c.workload["limits"]) <= names
    assert set(c.workload) <= WORKLOAD_KEYS
    for kind in ("end_to_end", "per_layer"):
        for m in c.metrics(kind):
            assert callable(spec.reader(m["name"]))
    kinds = [m["name"] for m in c.metrics("end_to_end")]
    assert "setup_s" in kinds and len(kinds) >= 2
    assert c.metrics("per_layer")


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def test_every_cell_reports_setup_and_another_metric():
    for cell in CELLS:
        c = spec.Cell(cell)
        names = {m["name"] for m in c.metrics("end_to_end")}
        assert "setup_s" in names and len(names - {"setup_s"}) >= 1


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _top(name):
    return name.partition(".")[0]


def _closure(start: Path):
    """The perfbench modules ``start`` imports, transitively."""
    seen, todo = set(), [start]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            if _top(name) != "perfbench":
                continue
            parts = name.split(".")[1:]
            for k in range(len(parts), 0, -1):
                cand = REPO / "perfbench" / Path(*parts[:k])
                for f in (cand.with_suffix(".py"), cand / "__init__.py"):
                    if f.exists():
                        todo.append(f)
                        break
    return seen


def test_nothing_run_imports_jax_or_the_jax_package():
    files = _closure(REPO / "perfbench" / "run.py")
    files |= set((REPO / "perfbench" / "metrics").glob("*.py"))
    assert REPO / "perfbench" / "system.py" in files
    for f in files:
        tops = {_top(n) for n in _imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for f in (REPO / "perfbench" / "reference").glob("*.py"):
        tops = {_top(n) for n in _imports(f)}
        assert not tops & (FORBIDDEN | {"bayesian_torch_tpu_torch"}), f
        # nor by a module of the benchmark that reaches the program
        for g in _closure(f):
            assert g.name != "system.py", (f, g)


def test_kernel_classes_load_and_sort():
    classes = spec.KernelClasses()
    assert classes("void batch_sample_kernel<8>(...)") == "sampler"
    assert classes("void sign_kernel<FlipOp>(BttSignGeom, FlipOp)") == \
        "signs"
    assert classes("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "comm"
    assert classes("a_kernel_no_class_has") == "other"


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


ADDED_READER = """from perfbench import roofline


def read(ctx):
    head = ctx["arch"].head
    bound = ctx["num_mc"] * roofline.bound_ms(
        2 * head.weight_numel, 2.0 * ctx["batch"] * head.macs_per_image,
        ctx["cfg"]["compute_dtype"])
    s = ctx["summary"]
    ms = s["class_ms"].get("added", 0.0) / s["units"]
    return 100.0 * bound / ms if ms > 0 else None
"""


def test_a_new_cell_is_new_files(tmp_path, monkeypatch):
    """A configuration, a mix, a cell that sets its own entry (the vmap
    emission), a roofline metric of a new kernel class and a metric read
    by an existing reader (its name less its last dotted part), added from
    a temporary copy: new files, and a BENCHMARK.json that names them; no
    file of perfbench/ changes. The cell's entry reaches the program
    unchanged, and the new reader reads the cell's shapes, batch and
    draws from ``ctx``.
    """
    before = _digests(REPO / "perfbench")
    entry = {"reduce": "mean", "emission": "vmap"}
    root = narrow.checkout(tmp_path, {"narrow.vmap": (
        narrow.config(), {"mode": "predict", "num_mc": 2, "batch": 2,
                          "ring": 2, "warmup": 1, "traced": 1,
                          "checked": 1},
        {"mean_gap": 1e-3, "kl_gap": 1e-3}, 1,
        {"entry": entry, "reference": "perfbench.reference.resnet",
         "build": {"remat_blocks": False},
         "settings": {"bayesian_torch_tpu_torch.ops.conv:CONV_1X1_DOT":
                      False}})})
    (root / "perfbench/metrics/added_roofline.infer.py").write_text(
        ADDED_READER)
    (root / "perfbench/kernel_classes/added.json").write_text(json.dumps(
        {"class": "added", "priority": 5, "patterns": ["^added_"]}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, unit, layer in (
            ("added_roofline.infer", "%", "added kernels"),
            ("launches_per_batch.infer.vmap", "launches", "host dispatch")):
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "higher",
            "source": "device_trace", "layer": layer,
            "moves": "infer_images_per_s", "workloads": ["narrow.vmap"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root / "perfbench")
    for rel, digest in before.items():
        assert after[rel] == digest, rel

    cell = spec.Cell("narrow.vmap", root)
    assert cell.config["image_size"] == 64 and cell.call == entry
    assert cell.build == {"remat_blocks": False} and cell.mesh == {"data": 1}
    assert spec.reference(cell).__name__ == "perfbench.reference.resnet"
    assert spec.reader_path("launches_per_batch.infer.vmap", root).name == \
        "launches_per_batch.infer.py"
    assert spec.KernelClasses(root)("added_kernel") == "added"
    a = arch_mod.resnet(cell.config)
    read = spec.reader("added_roofline.infer", root)
    ctx = {"arch": a, "cfg": cell.config, "batch": 2, "num_mc": 2,
           "summary": {"units": 2, "class_ms": {"added": 0.5}}}
    want = 2 * roofline.bound_ms(2 * a.head.weight_numel,
                                 4.0 * a.head.macs_per_image, "float32")
    assert read(ctx) == pytest.approx(100.0 * want / 0.25)

    from bayesian_torch_tpu_torch.parallel import mc

    seen, inner = [], mc.mc_forward

    def spy(model, x, num_mc, **kw):
        seen.append(kw)
        return inner(model, x, num_mc, **kw)
    monkeypatch.setattr(mc, "mc_forward", spy)
    res = run.run(cell, 5, 0.1, True, torch.device("cpu"), time.time())
    assert seen and all(kw == dict(entry, mesh=None) for kw in seen)
    # no card, no device rows: the readers find nothing and say so
    assert res["metrics"] == {} and set(res["checks"]) == {"mean_gap",
                                                           "kl_gap"}
