"""The modes of ``mc_forward`` and of the trainers that the port took last:
``structured=True``, ``parallel.mc_vmap``, the trainers' ``--remat`` and
``--structured-mc``, and ``utils/profiling.py``.

- ``structured=True`` is the vmap emission: equal to ``emission="vmap"``
  exactly with the generators rewound (eval, and a training step's loss,
  gradients and BN statistics), for both estimators; against JAX
  ``structured=True`` on the nets of ``tests/test_structured_mc.py`` (NHWC
  there, NCHW here, the same weights) draw for draw at rho = -25 within
  2e-4, and by the predictive mean with real noise (MC-64, within 6
  standard errors); a module that cannot take the draw axis makes it fall
  back to the loop with a warning naming it; ``mesh=`` still raises.
- ``mc_vmap`` against JAX ``mc_vmap`` on a ``LinearReparameterization``:
  shapes, and the draws' mean and spread by moments; lanes independent.
- The ImageNet trainer with ``--remat --structured-mc`` trains to the same
  weights as without them (remat replays the draws), and evaluates.
- ``summarize_trace`` on a CPU trace written by ``trace`` (no device rows)
  and on a hand-made chrome trace with kernel rows; the peak table.
"""

import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from bayesian_torch_tpu_torch.ops.sampling import module_generators
from bayesian_torch_tpu_torch.parallel import mc as tmc
from bayesian_torch_tpu_torch.utils import profiling
from tests._torch_port import FLIPOUT, REPARAM, jax_arrays, tiny_twins

S, B = 3, 2


# --- structured=True --------------------------------------------------------


def _rewound(model, *fns):
    """Each fn() in turn, the model's generators rewound before each."""
    gens = module_generators(model)
    states = [g.get_state() for g in gens]
    out = []
    for fn in fns:
        for g, st in zip(gens, states):
            g.set_state(st)
        out.append(fn())
    return out


def _parts(result):
    return result if isinstance(result, tuple) else (result,)


@pytest.mark.parametrize("estimator", [REPARAM, FLIPOUT])
def test_structured_equals_the_vmap_emission(estimator):
    _, tm, _ = tiny_twins(seed=41, estimator=estimator)
    x = torch.from_numpy(np.random.RandomState(42).randn(B, 3, 16, 16)
                         .astype(np.float32))
    for kw in (dict(), dict(reduce="mean"), dict(return_kl=False)):
        vmap, structured = _rewound(
            tm, lambda: tmc.mc_forward(tm, x, S, emission="vmap", **kw),
            lambda: tmc.mc_forward(tm, x, S, emission="scan",
                                   structured=True, **kw))
        for a, b in zip(_parts(vmap), _parts(structured)):
            assert torch.equal(a, b)

    state = {k: v.clone() for k, v in tm.state_dict().items()}

    def step(structured):
        tm.load_state_dict(state)
        tm.zero_grad()
        tm.train()
        outs, kl = tmc.mc_forward(tm, x, S, emission="vmap",
                                  structured=structured)
        loss = outs.float().mean() + kl / B
        loss.backward()
        return (loss.detach(), {n: p.grad.clone()
                                for n, p in tm.named_parameters()},
                {n: b.clone() for n, b in tm.named_buffers()})

    want, got = _rewound(tm, lambda: step(False), lambda: step(True))
    assert torch.equal(got[0], want[0])
    for part in (1, 2):
        for name in want[part]:
            assert torch.equal(got[part][name], want[part][name]), name


def _structured_twins(estimator, rho=None):
    """JAX's ``_Net`` / ``_RepNet`` (NHWC) and the port's NCHW twin with the
    same weights, eval mode; the JAX test's random BN statistics."""
    from bayesian_torch_tpu.layers import make_rngs
    from tests import test_structured_mc as jtest
    import bayesian_torch_tpu_torch.layers as tl
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state

    jm = (jtest._Net if estimator == FLIPOUT else jtest._RepNet)(
        make_rngs(0, noise_seed=1))
    jm.eval()
    rs = np.random.RandomState(3)
    jm.bn.running_mean[...] = jnp.asarray(rs.randn(8), jnp.float32)
    jm.bn.running_var[...] = jnp.asarray(rs.rand(8) + 0.5, jnp.float32)
    if rho is not None:
        for mod, attrs in ((jm.conv, ("rho_kernel", "rho_bias")),
                           (jm.fc, ("rho_weight", "rho_bias"))):
            for a in attrs:
                getattr(mod, a)[...] = getattr(mod, a)[...] * 0 + rho

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(0)
            self.conv = getattr(tl, f"Conv2d{estimator}")(3, 8, 3, padding=1,
                                                          generator=g)
            self.bn = tl.BatchNorm2dLayer(8)
            self.fc = getattr(tl, f"Linear{estimator}")(8, 5, generator=g)

        def forward(self, x):
            out, kl1 = self.conv(x)
            out = self.bn(torch.relu(out))
            out, kl2 = self.fc(out.mean(dim=(2, 3)))
            return out, kl1 + kl2

    tm = Net()
    load_jax_state(tm, jax_arrays(jm))
    return jm, tm.eval()


@pytest.mark.parametrize("estimator", [REPARAM, FLIPOUT])
def test_structured_matches_jax_structured(estimator):
    from bayesian_torch_tpu.parallel import mc_forward as jmc_forward

    x = np.random.RandomState(4).randn(B, 4, 4, 3).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    # rho = -25: every draw is the mean forward, draw for draw
    jm, tm = _structured_twins(estimator, rho=-25.0)
    want = np.asarray(jmc_forward(jm, jnp.asarray(x), S, return_kl=False,
                                  structured=True))
    got = tmc.mc_forward(tm, xt, S, return_kl=False, structured=True)
    assert got.shape == want.shape == (S, B, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # real noise: the predictive means agree within MC error
    jm, tm = _structured_twins(estimator)
    n = 64
    want = np.asarray(jmc_forward(jm, jnp.asarray(x), n, return_kl=False,
                                  structured=True))
    got = tmc.mc_forward(tm, xt, n, return_kl=False,
                         structured=True).numpy()
    se = (got.std(0) + want.std(0)) / np.sqrt(n) + 1e-3
    diff = np.abs(got.mean(0) - want.mean(0))
    assert (diff < 6 * se).all(), (diff / se).max()
    assert not np.allclose(got[0], got[1])


def test_structured_falls_back_and_mesh_raises():
    _, tm, _ = tiny_twins(seed=43)
    tm.head = nn.Linear(2, 2)  # parameters of its own, no draw axis
    x = torch.randn(B, 3, 16, 16)
    with pytest.warns(RuntimeWarning, match="module 'head' \\(Linear\\)"):
        out = tmc.mc_forward(tm, x, S, return_kl=False, structured=True)
    assert out.shape == (S, B, 10)
    # under a mesh of one process it falls back alike; a non-mesh raises
    from bayesian_torch_tpu_torch.parallel import make_mesh
    with pytest.warns(RuntimeWarning, match="module 'head' \\(Linear\\)"):
        meshed = tmc.mc_forward(tm, x, S, return_kl=False, structured=True,
                                mesh=make_mesh())
    assert meshed.shape == (S, B, 10)
    with pytest.raises(TypeError, match="make_mesh"):
        tmc.mc_forward(tm, x, S, structured=True, mesh=object())


# --- mc_vmap ----------------------------------------------------------------


def test_mc_vmap_matches_jax_mc_vmap_by_shape_and_moments():
    from flax import nnx

    from bayesian_torch_tpu.layers import \
        LinearReparameterization as JLinear
    from bayesian_torch_tpu.parallel import mc_vmap as jmc_vmap
    from bayesian_torch_tpu_torch.layers import LinearReparameterization
    from bayesian_torch_tpu_torch.parallel import mc_vmap

    n, k, o = 400, 6, 4
    tl = LinearReparameterization(k, o, generator=torch.Generator()
                                  .manual_seed(0), posterior_rho_init=-1.0)
    jl = JLinear(k, o, rngs=nnx.Rngs(params=0, noise=1))
    for name in ("mu_weight", "rho_weight", "mu_bias", "rho_bias"):
        getattr(jl, name)[...] = jnp.asarray(
            getattr(tl, name).detach().numpy())
    x = np.random.RandomState(5).randn(B, k).astype(np.float32)

    def forward(model, x):
        out, kl = model(x)
        return out, kl

    want, want_kl = jmc_vmap(n)(forward)(jl, jnp.asarray(x))
    with torch.no_grad():
        got, kl = mc_vmap(n)(forward)(tl, torch.from_numpy(x))
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (n, B, o)
    assert kl.shape == tuple(want_kl.shape) == (n,)
    np.testing.assert_allclose(kl.numpy(), np.asarray(want_kl), rtol=1e-5)
    se = (got.std(0) + want.std(0)) / np.sqrt(n)
    assert (np.abs(got.mean(0) - want.mean(0)) < 6 * se).all()
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.25)
    # independent lanes: no two draws alike, lane correlation near zero
    flat = got.reshape(n, -1) - got.reshape(n, -1).mean(0)
    corr = np.corrcoef(flat)[np.triu_indices(n, 1)]
    assert np.abs(corr).mean() < 0.5 and len(np.unique(got[:, 0, 0])) == n
    single = mc_vmap(2)(lambda m, x: m(x)[0])(tl, torch.from_numpy(x))
    assert single.shape == (2, B, o)


# --- the trainer's --remat and --structured-mc -----------------------------


def test_trainer_remat_and_structured_mc(tmp_path, monkeypatch):
    """``--remat`` replays each block's draws in the backward, so two
    epochs train to the weights of a run without it, bit for bit on the
    CPU; ``--structured-mc`` then evaluates through the draw axis."""
    from bayesian_torch_tpu_torch.examples import main_bayesian_imagenet
    from tests.test_torch_port_examples import _run, _small_imagenet

    monkeypatch.setattr(main_bayesian_imagenet, "load_imagenet_val",
                        _small_imagenet)
    calls = []
    real = tmc.mc_forward

    def spy(model, x, num_mc, **kw):
        calls.append((kw.get("structured", False),
                      getattr(model, "remat_blocks", None)))
        return real(model, x, num_mc, **kw)

    monkeypatch.setattr(main_bayesian_imagenet, "mc_forward", spy)
    from bayesian_torch_tpu_torch.examples import _engine
    monkeypatch.setattr(_engine, "mc_forward", spy)
    plain, flags = tmp_path / "plain", tmp_path / "flags"
    _run(plain, "--epochs=1")
    metrics = _run(flags, "--epochs=1", "--remat",
                   "--structured-mc")
    assert (False, True) in calls and (True, True) in calls
    assert 0.0 <= metrics["accuracy"] <= 1.0
    a = torch.load(plain / "imagenet_bayesian_resnet18.pt", weights_only=True)
    b = torch.load(flags / "imagenet_bayesian_resnet18.pt", weights_only=True)
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


# --- utils/profiling.py -----------------------------------------------------


def test_trace_and_summarize_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)) as logdir:
        a = torch.randn(64, 64)
        (a @ a).sum()
    assert logdir == str(tmp_path)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    assert profiling.summarize_trace(str(tmp_path)) == []  # no device rows
    host = dict(profiling.summarize_trace(str(tmp_path), top=50,
                                          device_only=False))
    assert any("mm" in name for name in host) and all(
        v >= 0 for v in host.values())


def test_summarize_a_chrome_trace_with_kernel_rows(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k_a", "dur": 1500.0},
        {"ph": "X", "cat": "kernel", "name": "k_b", "dur": 250.0},
        {"ph": "X", "cat": "kernel", "name": "k_a", "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9000.0},
        {"ph": "i", "cat": "kernel", "name": "instant"},
        {"ph": "M", "name": "process_name", "args": {"name": "GPU 0"}},
    ]
    (tmp_path / "a.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    with gzip.open(tmp_path / "b.pt.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": events[1:2]}, fh)
    got = profiling.summarize_trace(str(tmp_path))
    assert got == [("k_a", 2.0), ("k_b", 0.5), ("Memcpy HtoD", 0.1)]
    assert profiling.summarize_trace(str(tmp_path), top=1) == [("k_a", 2.0)]
    host = profiling.summarize_trace(str(tmp_path), device_only=False)
    assert host[0] == ("aten::mm", 9.0)


def test_device_peak_and_sol_fraction(monkeypatch):
    assert profiling.device_peak_tflops(123.0) == 123.0  # no card here
    assert not any("v5" in k or "v6" in k or "tpu" in k
                   for k in profiling.PEAK_BF16_TFLOPS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.0),
                       ("NVIDIA H100 PCIe", 756.0),
                       ("Some Other Card", 50.0)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0,
                            n=name: n)
        assert profiling.device_peak_tflops(50.0) == peak
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert profiling.sol_fraction(989e12 * 0.25, 0.5) == pytest.approx(0.5)
