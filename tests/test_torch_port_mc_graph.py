"""The CUDA-graph path of ``mc_forward``'s eval draw loop
(``parallel/mc_graph.py``) on the CPU: the presample's two halves against
the order in which the presample has always taken its numbers, the
batch run on the numbers' tensor form (the graph's static buffer) against
the eager batch, K-A's and K-H's plain versions with their seed or salts
from a tensor, which calls engage, what changes the key, and the cache's
first-eager / capture / replay / fallback sequence with the capture and
replay played on the CPU. The kernels reading the seed and salts on the
card, and real captures, are in ``tests/test_torch_port_cuda.py``.
"""

import collections
import contextlib
import gc
import warnings

import pytest
import torch

import bayesian_torch_tpu_torch.layers as layers
from bayesian_torch_tpu_torch.models.dnn_to_bnn import iter_bayesian_layers
from bayesian_torch_tpu_torch.ops import conv as conv_ops
from bayesian_torch_tpu_torch.ops.cuda import flipout_signs as kh
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from bayesian_torch_tpu_torch.ops.sampling import (DrawWindow, draw_seed,
                                                   draw_window, sign_block,
                                                   sign_salts,
                                                   sigma_from_rho)
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.parallel import mc_graph
from bayesian_torch_tpu_torch.utils import tracing
from tests._torch_port import FLIPOUT, REPARAM, TorchTiny

S = 3
ESTIMATORS = [REPARAM, FLIPOUT]


def _tiny(estimator, seed=0):
    return TorchTiny(torch.Generator().manual_seed(seed), estimator).eval()


def _x(seed=0, batch=2):
    return torch.randn(batch, 3, 16, 16,
                       generator=torch.Generator().manual_seed(100 + seed))


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_presample_halves_take_the_numbers_in_the_order_of_old(estimator):
    """One dtype group's seed, then layer by layer the bias noise and the
    Flipout salts' seed, all from the model's one generator; the draws
    made of them are K-A's over the concatenated posteriors."""
    tm = _tiny(estimator)
    gen = tm.conv1.generator
    state = gen.get_state()
    touched = dict(tmc._presample_layers(tm, S))
    after = gen.get_state()

    ref = torch.Generator()
    ref.set_state(state)
    seed = draw_seed(ref)
    eps_b, salts = {}, {}
    for layer in iter_bayesian_layers(tm):
        if layer.mu_bias is not None:
            eps_b[layer] = torch.randn((S,) + tuple(layer.mu_bias.shape),
                                       generator=ref)
        if estimator == FLIPOUT:
            s0 = draw_seed(ref)
            salts[layer] = [sign_salts(s0, s) for s in range(S)]
    assert torch.equal(ref.get_state(), after)
    assert any(layer.mu_bias is not None for layer in touched)

    flipout = estimator == FLIPOUT
    mus = [torch.zeros_like(tmc._posterior(layer)[0]) if flipout
           else tmc._posterior(layer)[0] for layer in touched]
    sigmas = [sigma_from_rho(tmc._posterior(layer)[1]) for layer in touched]
    w_all = ka.sample_scaled_normals_batch_plain(
        seed, torch.cat([m.reshape(-1) for m in mus]),
        torch.cat([s.reshape(-1) for s in sigmas]), S, torch.float32)
    parts = w_all.split([m.numel() for m in mus], dim=1)
    for (layer, attrs), mu, w in zip(touched.items(), mus, parts):
        assert torch.equal(attrs["_presampled_w"],
                           w.reshape((S,) + tuple(mu.shape)))
        if layer in eps_b:
            b = sigma_from_rho(layer.rho_bias) * eps_b[layer]
            assert torch.equal(attrs["_presampled_b"],
                               b if flipout else layer.mu_bias + b)
        if flipout:
            assert attrs["_presampled_signs"].tolist() == \
                [list(p) for p in salts[layer]]
        else:
            assert "_presampled_signs" not in attrs


@pytest.mark.parametrize("reduce", [None, "mean"])
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_the_numbers_as_tensors_give_the_eager_batch(estimator, reduce):
    """The graph's device half: the numbers as tensors (seeds and salts
    read where the draws are made) give the eager batch bit for bit."""
    tm = _tiny(estimator)
    x = _x()
    gen = tm.conv1.generator
    state = gen.get_state()
    want, kl_want = tmc.mc_forward(tm, x, S, reduce=reduce)
    gen.set_state(state)
    numbers = tmc._presample_numbers(tm, S)
    on = numbers.on([t.clone() for t in numbers.tensors()])
    assert all(torch.is_tensor(s) for s in on.seeds)
    seen = []

    def spy(model, num_mc):
        touched = tmc._presample_apply(model, num_mc, on)
        seen.extend(attrs.get("_presampled_signs") for _, attrs in touched)
        return touched

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tmc, "_presample_layers", spy)
        got, kl = tmc.mc_forward(tm, x, S, reduce=reduce)
    assert torch.equal(got, want) and torch.equal(kl, kl_want)
    salts = [t for t in seen if t is not None]
    assert [id(t) for t in salts] == ([id(on.salts[layer]) for layer in
                                       on.salts] if estimator == FLIPOUT
                                      else [])
    for mod in tm.modules():
        assert not any(k.startswith("_presampled") for k in vars(mod))


@pytest.mark.parametrize("case", ["sampler", "sampler_window", "flip",
                                  "combine", "lanes"])
def test_seed_and_salts_from_a_tensor_match_by_value(case):
    g = torch.Generator().manual_seed(7)
    if case.startswith("sampler"):
        mu, rho = torch.randn(37, generator=g), torch.randn(37, generator=g)
        seed = 0x1234_5678_9ABC_DEF0
        window = (2, 50, 5) if case == "sampler_window" else None
        want = ka.sample_scaled_normals_batch_plain(
            seed, mu, sigma_from_rho(rho), 3, torch.float32, window)
        got = ka.sample_scaled_normals_batch(
            torch.tensor([seed]), mu, sigma_from_rho(rho), 3,
            torch.float32, window)
        assert torch.equal(got, want)
        return
    salts = [0x9E37_79B9, 0x0123_4567, 0xFFFF_FFFF]
    x = torch.randn(2, 5, 7, generator=g)
    if case == "flip":
        want = kh.sign_flip(x, sign_block(salts[:1], x.shape))
        got = kh.sign_flip(x, sign_block(torch.tensor(salts[:1]), x.shape))
    elif case == "combine":
        pert = torch.randn(2, 5, 7, generator=g)
        want = kh.sign_combine(x, pert, sign_block(salts[1:2], x.shape,
                                                   output=True))
        got = kh.sign_combine(x, pert, sign_block(torch.tensor(salts[1:2]),
                                                  x.shape, output=True))
    else:
        xs = torch.randn(2, 3, 5, 7, generator=g)
        want = kh.sign_flip(xs, sign_block(salts, x.shape, axis=1))
        got = kh.sign_flip(xs, sign_block(torch.tensor(salts), x.shape,
                                          axis=1))
    assert torch.equal(got, want) and not torch.equal(got.abs(), got)


def _engages(model, **over):
    args = dict(device=torch.device("cuda"), num_mc=S, vmap=False,
                presample="on", mesh=None, remat_policy=None)
    args.update(over)
    return mc_graph.engages(model, args.pop("device"), args.pop("num_mc"),
                            **args)


@pytest.mark.parametrize("case", [
    "engaged", "cpu", "training", "mesh", "window", "vmap", "presample_off",
    "one_draw", "remat", "int8", "lstm", "calibrating", "hook",
    "global_hook"])
def test_what_engages_the_graph(case):
    """Every excluded case runs the eager path."""
    tm = _tiny(REPARAM)
    if case.endswith("hook"):
        register = (torch.nn.modules.module.register_module_forward_hook
                    if case == "global_hook"
                    else tm.layer1[0].register_forward_hook)
        handle = register(lambda *a: None)
        try:
            assert not _engages(tm)
        finally:
            handle.remove()
        assert _engages(tm)
        return
    over = {"cpu": dict(device=torch.device("cpu")),
            "mesh": dict(mesh=object()), "vmap": dict(vmap=True),
            "presample_off": dict(presample="off"),
            "one_draw": dict(num_mc=1), "remat": dict(remat_policy="full")}
    if case == "training":
        tm.layer1.train()
    elif case == "int8":
        tm.extra = layers.QuantizedLinearFlipout(4, 4).eval()
    elif case == "lstm":
        tm.extra = layers.LSTMReparameterization(4, 4).eval()
    elif case == "calibrating":
        tm.fc.quant_prepare = True
    if case == "window":
        with draw_window(DrawWindow(0, 1, 2, 0, 2, 2)):
            assert not _engages(tm)
        return
    assert _engages(tm, **over.get(case, {})) == (case == "engaged")


@pytest.mark.parametrize("change", [
    "none", "copy_", "replaced", "dtype", "x_shape", "setting",
    "compute_dtype", "bn_eps", "padding", "plain_tensor"])
def test_what_changes_the_key(monkeypatch, change):
    tm = _tiny(REPARAM)
    x = _x()
    before = mc_graph.key(list(tm.modules()), x, (S, "mean", True))
    with torch.no_grad():
        if change == "copy_":
            tm.conv1.mu_kernel.copy_(torch.zeros_like(tm.conv1.mu_kernel))
        elif change == "replaced":
            tm.conv1.mu_kernel = torch.nn.Parameter(
                tm.conv1.mu_kernel.detach().clone())
        elif change == "dtype":
            tm.fc.mu_weight.data = tm.fc.mu_weight.data.double()
        elif change == "x_shape":
            x = _x(batch=3)
        elif change == "setting":
            monkeypatch.setattr(conv_ops, "CONV_1X1_DOT", True)
        elif change == "compute_dtype":
            tm.conv1.compute_dtype = torch.bfloat16
        elif change == "bn_eps":
            tm.bn1.eps = 1e-3
        elif change == "padding":
            tm.conv1.padding = (0, 0)
        elif change == "plain_tensor":
            tm.fc.scale = torch.ones(3)
    after = mc_graph.key(list(tm.modules()), x, (S, "mean", True))
    assert (after == before) == (change in ("none", "copy_"))


class _CpuGraph(mc_graph._Graph):
    """A key's graph with its capture and replay played on the CPU: the
    capture keeps the batch's function, a replay runs it on the staged
    numbers' tensor form (what the graph's static buffer holds)."""

    fail = False

    def __init__(self, x, numbers):
        self.x = torch.empty_like(x)
        self.views = [torch.empty_like(t) for t in numbers.tensors()]
        self.launches = {}

    def load(self, x, numbers):
        for view, t in zip(self.views, numbers.tensors()):
            view.copy_(t)
        self.x.copy_(x)

    def capture(self, device_fn, numbers, pool, stream):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        self.fn, self.numbers = device_fn, numbers.on(self.views)

    def replay(self):
        result, kl = self.fn(self.x, self.numbers)
        return result.clone(), kl


class _CpuDevice(mc_graph._Device):
    def __init__(self, device):
        self.pool = self.stream = None
        self.graphs = collections.OrderedDict()
        self.seen = collections.OrderedDict()
        self.failed = {}


@pytest.fixture
def cpu_graphs(monkeypatch):
    """``mc_forward`` engaging the graph path on the CPU (the capture and
    replay played by ``_CpuGraph``)."""
    monkeypatch.setattr(mc_graph, "_Graph", _CpuGraph)
    monkeypatch.setattr(mc_graph, "_Device", _CpuDevice)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    real = mc_graph.engages
    monkeypatch.setattr(mc_graph, "engages", lambda model, device, *a,
                        **k: real(model, torch.device("cuda"), *a, **k))
    mc_graph.reset()
    yield
    mc_graph.reset()


@contextlib.contextmanager
def _no_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield []


def _counts():
    got = tracing.launches()
    return {k: got[k] for k in ("captures", "replays", "fallbacks")}


@pytest.mark.parametrize("fail", [False, True])
@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_first_eager_then_capture_then_replays(monkeypatch, cpu_graphs,
                                               estimator, fail):
    """Four batches through the graph path are the eager path's four, bit
    for bit, each on fresh draws; the first batch's result is left as it
    was; one capture and three replays, or one fallback that warns once
    and keeps the key eager."""
    monkeypatch.setattr(_CpuGraph, "fail", fail)
    tm = _tiny(estimator)
    gen = tm.conv1.generator
    state = gen.get_state()
    xs = [_x(i) for i in range(4)]
    before = _counts()
    with pytest.warns() if fail else _no_warning() as caught:
        got = [tmc.mc_forward(tm, x, S, reduce="mean") for x in xs]
    if fail:
        assert [str(w.message)[:41] for w in caught] == [
            "mc_forward: capturing the MC batch as a C"]
    kept = got[0][0].clone()
    counts = {k: v - before[k] for k, v in _counts().items()}
    assert counts == ({"captures": 0, "replays": 0, "fallbacks": 1} if fail
                      else {"captures": 1, "replays": 3, "fallbacks": 0})
    monkeypatch.setattr(mc_graph, "engages", lambda *a, **k: False)
    gen.set_state(state)
    want = [tmc.mc_forward(tm, x, S, reduce="mean") for x in xs]
    for (m, kl), (wm, wkl) in zip(got, want):
        assert torch.equal(m, wm) and torch.equal(kl, wkl)
    assert not torch.equal(got[1][0], got[2][0])
    assert torch.equal(got[0][0], kept)


def test_the_graphs_kept_and_forgotten(cpu_graphs):
    """The most recently used ``GRAPHS`` keys keep their graphs; a
    collected model's graphs go, and so do its keys seen once or fallen
    back."""
    tm = _tiny(REPARAM)
    state = mc_graph._DEVICES
    for batch in range(1, mc_graph.GRAPHS + 2):
        for _ in range(2):
            tmc.mc_forward(tm, _x(batch=batch), S, reduce="mean")
    (dev,) = state.values()
    assert [k[2][0] for k in dev.graphs] == list(
        range(2, mc_graph.GRAPHS + 2))
    for graph in dev.graphs.values():
        graph.fn = graph.numbers = None  # a graph holds no module
    tm.fc.eps = 0.5  # a new key, seen once
    tmc.mc_forward(tm, _x(), S, reduce="mean")
    dev.failed[(id(tm),)] = None
    assert dev.seen and dev.failed
    del tm
    gc.collect()
    assert not dev.graphs and not dev.seen and not dev.failed


@pytest.mark.parametrize("change", ["bn_eps", "training"])
def test_a_changed_value_or_training_captures_anew(cpu_graphs, change):
    """A module's plain value changed after the capture (a BatchNorm's
    ``eps``) makes a new key, eager once and then captured, whose batches
    read the new value; a batch in training drops the model's graphs, and
    the next eval batches capture anew."""
    tm = _tiny(REPARAM)
    x = _x()
    for _ in range(2):
        tmc.mc_forward(tm, x, S, reduce="mean")
    (dev,) = mc_graph._DEVICES.values()
    before = _counts()
    if change == "bn_eps":
        tm.bn1.eps = 1e-3
    else:
        tm.train()
        tmc.mc_forward(tm, x, S, reduce="mean")
        assert not dev.graphs
        tm.eval()
    gen = tm.conv1.generator
    state = gen.get_state()
    got = [tmc.mc_forward(tm, x, S, reduce="mean") for _ in range(3)]
    counts = {k: v - before[k] for k, v in _counts().items()}
    assert counts == {"captures": 1, "replays": 2, "fallbacks": 0}
    assert len(dev.graphs) == (2 if change == "bn_eps" else 1)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mc_graph, "engages", lambda *a, **k: False)
        gen.set_state(state)
        want = [tmc.mc_forward(tm, x, S, reduce="mean") for _ in range(3)]
    for (a, kl), (wa, wkl) in zip(got, want):
        assert torch.equal(a, wa) and torch.equal(kl, wkl)
