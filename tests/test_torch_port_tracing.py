"""The port's spans and launch counters (``utils/tracing.py``) and the
benchmark's readers of them (``perfbench/spans.py``), on the CPU.

- Off (no profiler): a span is the shared null context and no unit is
  recorded.
- On (a ``torch.profiler`` session): the ``btt.*`` annotations nest as
  placed and carry their unit's id; a synthetic case on a fake clock
  gives each span's count and inclusive time, a span on another thread
  counts to the open unit (32 threads lose no count), and the store
  keeps the last 256 units.
- A narrow Bayesian ResNet's MC-3 ``mc_forward``: one unit, a
  ``layer.bayes`` span a layer and draw under the loop, a layer under
  the vmap emission (inside ``_DrawsLast``, whose results the spans
  leave as they are); a training step is one ``train_step`` unit.
- ``launches()`` reads every wrapper's ``launches``.
- Each reader: the median of a synthetic store, None from an empty one.
"""

import sys
import threading
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bayesian_torch_tpu_torch.examples._engine import make_train_step
from bayesian_torch_tpu_torch.models._large_resnet import (Bottleneck,
                                                            LargeResNet)
from bayesian_torch_tpu_torch.ops.cuda import (flipout_signs, mc_gemm,
                                               qmatmul, sampled_matmul,
                                               sampled_weights)
from bayesian_torch_tpu_torch.parallel.mc import mc_forward
from bayesian_torch_tpu_torch.utils import tracing
from perfbench import spec

# the narrow ResNet: the stem, 4 bottlenecks of 3 convs, 4 downsample
# convs and the head; a BatchNorm after each conv but the head
LAYERS, BNS, BLOCKS = 18, 17, 4
S = 3

WRAPPERS = {
    sampled_weights: ("sample_scaled_normals_batch", "dsigma", "drho"),
    sampled_matmul: ("sampled_matmul", "sampled_matmul_batched",
                     "sampled_matmul_dx", "sampled_matmul_dw",
                     "sampled_matmul_dx_batched",
                     "sampled_matmul_dw_batched"),
    mc_gemm: ("mc_gemm", "pointwise_gemm", "mc_gemm_cl",
              "pointwise_gemm_cl"),
    qmatmul: ("qmatmul_requant", "qmatmul_requant_flipout"),
    flipout_signs: ("sign_flip", "sign_combine", "qsign_mul"),
}


@pytest.fixture(autouse=True)
def _fresh_store():
    tracing.reset()
    yield
    tracing.reset()


def _on():
    return profile(activities=[ProfilerActivity.CPU])


def _model(estimator="Reparameterization", data_format="NCHW", seed=0):
    return LargeResNet(Bottleneck, [1, 1, 1, 1], num_classes=10,
                       estimator=estimator, data_format=data_format,
                       generator=torch.Generator().manual_seed(seed))


def _x(data_format="NCHW"):
    shape = (2, 32, 32, 3) if data_format == "NHWC" else (2, 3, 32, 32)
    return torch.randn(shape, generator=torch.Generator().manual_seed(1))


class _Clock:
    """A ``time`` stand-in whose ``perf_counter_ns`` moves when told."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns

    def tick(self, ms):
        self.ns += int(ms * 1e6)


@pytest.fixture
def annotations(monkeypatch):
    """Every ``record_function`` opened, as (name, args)."""
    seen = []
    base = torch.autograd.profiler.record_function

    class Spy(base):
        def __init__(self, name, args=None):
            seen.append((name, args))
            super().__init__(name, args)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    return seen


def test_off_a_span_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("draw") is tracing._NULL
    assert tracing.kernel_span(flipout_signs.sign_flip) is tracing._NULL

    @tracing.spanned("layer.bayes")
    def f(a, b=1):
        return a + b
    with tracing.span("mc_forward"):
        with tracing.span("draw"):
            assert f(1, b=2) == 3
    assert tracing.units() == []
    m = _model()
    m.eval()
    mc_forward(m, _x(), S, reduce="mean")
    assert tracing.units() == []


def test_on_the_annotations_nest_as_placed_and_carry_the_unit(annotations):
    m = _model()
    m.eval()
    with _on() as prof:
        mc_forward(m, _x(), S, reduce="mean")
        mc_forward(m, _x(), S, reduce="mean")
    first, second = tracing.units()
    assert second["id"] == first["id"] + 1
    ours = [(n, a) for n, a in annotations if n.startswith("btt.")]
    assert {a for _, a in ours} == {str(first["id"]), str(second["id"])}
    half = len(ours) // 2
    assert all(a == str(first["id"]) for _, a in ours[:half])

    def btt_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("btt."):
            p = p.cpu_parent
        return None if p is None else p.name

    events = [e for e in prof.events() if e.name.startswith("btt.")]
    assert all(e.is_user_annotation for e in events)
    parents = {}
    for e in events:
        parents.setdefault(e.name, set()).add(btt_parent(e))
    assert parents["btt.mc_forward"] == {None}
    assert parents["btt.presample"] == {"btt.mc_forward"}
    assert parents["btt.kernel.sample_scaled_normals_batch"] == {
        "btt.presample"}
    assert parents["btt.draw"] == {"btt.mc_forward"}
    assert parents["btt.block"] == {"btt.draw"}
    assert parents["btt.layer.bayes"] == {"btt.draw", "btt.block"}
    assert parents["btt.layer.bn"] == {"btt.draw", "btt.block"}
    names = [e.name for e in events]
    assert names.count("btt.layer.bayes") == 2 * S * LAYERS


def test_counts_inclusive_times_threads_and_the_ring(monkeypatch,
                                                     annotations):
    clock = _Clock()
    monkeypatch.setattr(tracing, "time", clock)

    def worker():
        with tracing.span("worker"):
            clock.tick(4)

    with _on():
        with tracing.span("outer"):
            clock.tick(5)
            with tracing.span("inner"):
                clock.tick(3)
                with tracing.span("inner"):  # counted, timed by the outer
                    clock.tick(2)
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            clock.tick(1)
        with tracing.span("second"):
            clock.tick(7)
    first, second = tracing.units()
    assert first["name"] == "outer" and first["host_ms"] == 15.0
    assert first["spans"] == {"outer": {"count": 1, "ms": 15.0},
                              "inner": {"count": 2, "ms": 5.0},
                              "worker": {"count": 1, "ms": 4.0}}
    assert second["name"] == "second" and second["host_ms"] == 7.0
    assert second["id"] == first["id"] + 1
    tags = dict(annotations)
    assert tags["btt.worker"] == tags["btt.outer"] == str(first["id"])
    assert tags["btt.second"] == str(second["id"])

    with _on():
        for _ in range(tracing.RING + 44):
            with tracing.span("unit"):
                clock.tick(1)
    kept = tracing.units()
    assert len(kept) == tracing.RING
    assert [u["id"] for u in kept] == list(
        range(kept[0]["id"], kept[0]["id"] + tracing.RING))
    assert kept[0]["id"] == second["id"] + 45



def test_threads_lose_no_span():
    """More threads than cores, switching often, each opening spans that
    count to the one open unit: no count is lost."""
    threads, spans = 32, 200
    interval = sys.getswitchinterval()

    def worker():
        for _ in range(spans):
            with tracing.span("worker"):
                pass

    sys.setswitchinterval(1e-6)
    try:
        with _on():
            with tracing.span("outer"):
                pool = [threading.Thread(target=worker)
                        for _ in range(threads)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    (unit,) = tracing.units()
    assert unit["spans"]["worker"]["count"] == threads * spans
@pytest.mark.parametrize("estimator", ["Reparameterization", "Flipout"])
def test_mc_forward_loop_one_unit_a_span_a_layer_and_draw(estimator):
    m = _model(estimator)
    m.eval()
    with _on():
        mc_forward(m, _x(), S, reduce="mean")
    (unit,) = tracing.units()
    spans = {k: v["count"] for k, v in unit["spans"].items()}
    want = {"mc_forward": 1, "presample": 1,
            "kernel.sample_scaled_normals_batch": 1, "draw": S,
            "block": S * BLOCKS, "layer.bayes": S * LAYERS,
            "layer.bn": S * BNS}
    if estimator == "Flipout":
        want.update({"kernel.sign_flip": S * LAYERS,
                     "kernel.sign_combine": S * LAYERS})
    assert unit["name"] == "mc_forward" and spans == want
    assert unit["host_ms"] == unit["spans"]["mc_forward"]["ms"] > 0
    inside = sum(unit["spans"][k]["ms"] for k in ("layer.bayes",
                                                  "layer.bn"))
    assert inside <= unit["host_ms"]
    assert unit["launches"] == {}  # the CPU takes the plain versions


@pytest.mark.parametrize("estimator", ["Reparameterization", "Flipout"])
def test_vmap_emission_under_draws_last(estimator):
    """Channels-last under the vmap emission runs inside ``_DrawsLast``:
    one draw span, a ``layer.bayes`` a layer, and the same outputs and
    KL as with no profiler."""
    outs = []
    for traced in (False, True):
        m = _model(estimator, "NHWC")
        m.train()
        x = _x("NHWC")
        if traced:
            with _on():
                out, kl = mc_forward(m, x, S, emission="vmap")
        else:
            out, kl = mc_forward(m, x, S, emission="vmap")
        outs.append((out.detach(), kl.detach()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    (unit,) = tracing.units()
    spans = {k: v["count"] for k, v in unit["spans"].items()}
    assert spans["draw"] == 1 and spans["layer.bayes"] == LAYERS
    assert spans["layer.bn"] == BNS and spans["block"] == BLOCKS
    assert spans["bn_ema"] == BNS and "presample" not in spans


def test_a_training_step_is_one_unit():
    m = _model()
    m.train()
    step = make_train_step(num_mc=S, batch_size=2)
    opt = torch.optim.SGD(m.parameters(), lr=0.01, momentum=0.9)
    with _on():
        step(m, opt, _x(), torch.tensor([1, 2]))
    (unit,) = tracing.units()
    spans = {k: v["count"] for k, v in unit["spans"].items()}
    assert unit["name"] == "train_step"
    assert {k: spans[k] for k in ("train_step", "mc_forward", "draw",
                                  "backward", "optimizer")} == dict.fromkeys(
        ("train_step", "mc_forward", "draw", "backward", "optimizer"), 1)
    # the samplers' backward (K-C) runs inside the backward
    assert spans["kernel.dsigma"] == LAYERS
    ms = {k: v["ms"] for k, v in unit["spans"].items()}
    assert ms["mc_forward"] + ms["backward"] + ms["optimizer"] <= \
        unit["host_ms"]


def test_launches_reads_every_wrapper(monkeypatch):
    names = [n for ns in WRAPPERS.values() for n in ns]
    assert set(tracing.launches()) >= set(names)
    for module, ns in WRAPPERS.items():
        for n in ns:
            monkeypatch.setattr(getattr(module, n), "launches",
                                7 + names.index(n))
    got = tracing.launches()
    for module, ns in WRAPPERS.items():
        for n in ns:
            assert got[n] == getattr(module, n).launches == \
                7 + names.index(n)
    with _on():
        with tracing.span("unit"):
            flipout_signs.sign_flip.launches += 2
            mc_gemm.mc_gemm_cl.launches += 1
    (unit,) = tracing.units()
    assert unit["launches"] == {"sign_flip": 2, "mc_gemm_cl": 1}


def _record(name, host_ms, spans=None):
    return {"id": 0, "name": name, "host_ms": host_ms, "launches": {},
            "spans": {k: {"count": 1, "ms": v}
                      for k, v in (spans or {}).items()}}


def _infer(host_ms, bayes, bn, flip, combine):
    return _record("mc_forward", host_ms, {
        "layer.bayes": bayes, "layer.bn": bn, "kernel.sign_flip": flip,
        "kernel.sign_combine": combine})


STORE = [
    _infer(100.0, 50.0, 20.0, 5.0, 6.0),
    _infer(120.0, 70.0, 30.0, 7.0, 8.0),
    _infer(300.0, 90.0, 40.0, 9.0, 10.0),
    _record("train_step", 280.0, {"layer.bayes": 40.0}),
    _record("train_step", 290.0, {"layer.bayes": 40.0}),
    _record("block", 5.0, {"layer.bayes": 4.0}),
]
# units that hold none of the layers' spans
BARE = [_record("mc_forward", 110.0), _record("train_step", 270.0)]


@pytest.mark.parametrize("name,mode,want,bare", [
    ("host_ms_per_batch.infer", "predict", 120.0, 110.0),
    ("host_ms_per_step.train", "train", 285.0, 270.0),
    ("conv_host_ms_per_batch.infer", "predict", 70.0, None),
    ("bn_host_ms_per_batch.infer", "predict", 30.0, None),
    ("signs_host_ms_per_batch.infer", "predict", 15.0, None),
])
def test_each_reader_a_median_or_none(monkeypatch, name, mode, want, bare):
    read = spec.reader(name)
    other = "train" if mode == "predict" else "predict"
    monkeypatch.setattr(tracing, "_units", deque(STORE))
    assert read({"mode": mode}) == want
    assert read({"mode": other}) is None
    monkeypatch.setattr(tracing, "_units", deque(BARE))
    assert read({"mode": mode}) == bare
    tracing.reset()
    assert read({"mode": mode}) is None
