"""The port's native data loader (``bayesian_torch_tpu_torch.data``) and
the trainers' epoch order (ROADMAP F7), against the JAX package:

- the eight cases of tests/test_data_loader.py on the port's loader;
- the native epoch order equals the JAX loader's (the C++
  ``mt19937_64(seed + epoch * 0x9E3779B9)`` Fisher-Yates pass), the numpy
  path equals JAX's numpy path (``RandomState(seed + epoch)``);
- the library is built with ``g++`` into the git-ignored ``_build/``,
  named by a hash of the source, never next to the source; two processes
  building it at once both get a whole library; a failed build warns
  once, naming the error;
- F7: the engine's ``train`` sees the JAX engine's batches, epoch by
  epoch, where the old ``_data.batches(seed=epoch)`` order did not; one
  epoch of ``train`` on a Bayesian linear model whose weights the order
  decides ends at the JAX engine's weights.
"""

import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from bayesian_torch_tpu.data import DataLoader as JaxLoader
from bayesian_torch_tpu_torch.data import DataLoader, native_available
from bayesian_torch_tpu_torch.data import loader as tloader


def _dataset(n=257, shape=(3, 8, 8)):
    rs = np.random.RandomState(0)
    x = rs.randn(n, *shape).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int32)
    return x, y


# --- the JAX package's eight loader cases -----------------------------------


def test_native_lib_builds():
    assert native_available(), "g++ build of the port's loader.cpp failed"


def test_epoch_covers_every_sample_once():
    x, y = _dataset(256)
    loader = DataLoader(x, y, batch_size=32, shuffle=True, num_workers=4)
    seen = []
    for xb, yb in loader.epoch(0):
        assert xb.shape == (32, 3, 8, 8) and yb.shape == (32,)
        seen.append(yb)
    seen = np.concatenate(seen)
    assert len(seen) == 256
    assert sorted(seen.tolist()) == sorted(y.tolist())


def test_x_y_pairing_preserved():
    x, y = _dataset(128, shape=(4,))
    x[:, 0] = np.arange(128, dtype=np.float32)
    loader = DataLoader(x, y, batch_size=16, shuffle=True, num_workers=3)
    for xb, yb in loader.epoch(1):
        np.testing.assert_array_equal(yb, y[xb[:, 0].astype(int)])


def test_shuffle_determinism_per_seed():
    x, y = _dataset(128, shape=(4,))
    l1 = DataLoader(x, y, batch_size=16, seed=7, num_workers=2)
    l2 = DataLoader(x, y, batch_size=16, seed=7, num_workers=4)
    for (_, a), (_, b) in zip(l1.epoch(0), l2.epoch(0)):
        np.testing.assert_array_equal(a, b)


def test_epochs_reshuffle():
    x, y = _dataset(128, shape=(4,))
    loader = DataLoader(x, y, batch_size=128, seed=3, num_workers=2)
    e1 = next(iter(loader.epoch(0)))[1].copy()
    _ = list(loader.epoch(0))
    e2 = next(iter(loader.epoch(1)))[1].copy()
    assert np.any(e1 != e2)


def test_normalization_fused():
    x, y = _dataset(64, shape=(4,))
    loader = DataLoader(x, y, batch_size=64, shuffle=False, num_workers=2,
                        scale=2.0, shift=0.5)
    xb, _ = next(iter(loader.epoch(0)))
    np.testing.assert_allclose(xb, (x - 0.5) * 2.0, rtol=1e-6)


def test_drop_last_false():
    x, y = _dataset(100, shape=(4,))
    loader = DataLoader(x, y, batch_size=32, drop_last=False, shuffle=False,
                        num_workers=2)
    assert [len(yb) for _, yb in loader.epoch(0)] == [32, 32, 32, 4]
    assert len(loader) == 4


def test_numpy_fallback_equivalence():
    x, y = _dataset(64, shape=(4,))
    loader = DataLoader(x, y, batch_size=16, shuffle=False, num_workers=2)
    native = [(xb.copy(), yb.copy()) for xb, yb in loader.epoch(0)]
    fallback = list(loader._numpy_epoch(0))
    assert len(native) == len(fallback) == 4
    for (nx, ny), (fx, fy) in zip(native, fallback):
        np.testing.assert_allclose(nx, fx)
        np.testing.assert_array_equal(ny, fy)


# --- the port against the JAX loader ---------------------------------------


def _order(loader, epoch, numpy_path=False):
    it = loader._numpy_epoch(epoch) if numpy_path else loader.epoch(epoch)
    return [xb[:, 0].astype(int).tolist() for xb, _ in it]


@pytest.mark.parametrize("seed,epoch,batch,n", [(0, 0, 16, 64),
                                                (0, 1, 16, 64),
                                                (5, 2, 32, 257),
                                                (2**40 + 3, 7, 50, 200)])
def test_native_order_and_values_equal_jax(seed, epoch, batch, n):
    x, y = _dataset(n, shape=(3,))
    x[:, 0] = np.arange(n, dtype=np.float32)
    kw = dict(batch_size=batch, seed=seed, num_workers=3)
    ours, theirs = DataLoader(x, y, **kw), JaxLoader(x, y, **kw)
    assert _order(ours, epoch) == _order(theirs, epoch)
    for (a, ay), (b, by) in zip(DataLoader(x, y, scale=3.0, shift=0.25,
                                           **kw).epoch(epoch),
                                JaxLoader(x, y, scale=3.0, shift=0.25,
                                          **kw).epoch(epoch)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ay, by)


def test_numpy_path_equals_jax_numpy_path():
    x, y = _dataset(100, shape=(2,))
    x[:, 0] = np.arange(100, dtype=np.float32)
    kw = dict(batch_size=16, seed=4, scale=2.0, shift=1.0)
    ours, theirs = DataLoader(x, y, **kw), JaxLoader(x, y, **kw)
    for epoch in (0, 3):
        got = list(ours._numpy_epoch(epoch))
        want = list(theirs._numpy_epoch(epoch))
        assert len(got) == len(want) == 6
        for (a, ay), (b, by) in zip(got, want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ay, by)
    # the numpy path's shuffled order is not the native one (JAX's too)
    assert _order(ours, 0, numpy_path=True) != _order(ours, 0)


def test_library_is_built_under_build_named_by_the_source():
    assert native_available()
    path = tloader.library_path()
    assert path.exists() and path.parent == tloader._BUILD_DIR
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "bayesian_torch_tpu_torch"
    assert not list(tloader._SRC.parent.glob("*.so"))  # nothing by the source
    assert tloader._SRC.read_text().count("mt19937_64") == 1


def test_concurrent_builds_both_get_a_whole_library(tmp_path):
    """Two processes building into one empty directory at once (two ranks
    starting together): each compiles to a temporary file and renames it,
    so both load a whole library."""
    code = textwrap.dedent(f"""
        import ctypes, pathlib
        from bayesian_torch_tpu_torch.data import loader
        loader._BUILD_DIR = pathlib.Path({str(tmp_path)!r})
        out = loader.library_path()
        loader._build_lib(out)
        ctypes.CDLL(str(out)).bt_loader_create
        print("BUILT", out.name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "BUILT" in out, out
    assert [f.name for f in tmp_path.iterdir()] == [
        outs[0].split()[-1]]  # one library, no temporary left


def test_failed_build_warns_once_naming_the_error(tmp_path, monkeypatch):
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tloader, "_SRC", bad)
    monkeypatch.setattr(tloader, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tloader, "_LIB", None)
    monkeypatch.setattr(tloader, "_ERROR", None)
    with pytest.warns(RuntimeWarning, match="g\\+\\+ failed"):
        assert not native_available()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native_available()  # remembered, no second warning
        x, y = _dataset(32, shape=(2,))
        loader = DataLoader(x, y, batch_size=8, seed=1)
    assert loader._lib is None
    got = [yb for _, yb in loader.epoch(2)]
    want = [yb for _, yb in loader._numpy_epoch(2)]
    assert len(got) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --- F7: the trainers' epoch order ------------------------------------------


def _record_steps(monkeypatch, engine, out):
    """Replace the engine's step with one that records each batch's row
    indices (column 0 of x) and returns zeros."""
    def make_train_step(*args, **kwargs):
        def step(model, optimizer, x, y):
            out.append(np.asarray(x)[:, 0].astype(int).tolist())
            return 0.0, 0.0, 0.0
        return step
    monkeypatch.setattr(engine, "make_train_step", make_train_step)


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_engine_epoch_order_equals_jax(epoch, monkeypatch, capsys):
    """The port's ``train`` takes the JAX ``train``'s batches in its order
    at epoch seed ``epoch`` (each engine's ``DataLoader``, seed 0); the
    port's old order, ``_data.batches(seed=epoch)``, was another (F7)."""
    from bayesian_torch_tpu.examples import _engine as jengine
    from bayesian_torch_tpu_torch.examples import _data as tdata
    from bayesian_torch_tpu_torch.examples import _engine as tengine

    n, bs = 64, 16
    x = np.zeros((n, 1, 2, 2), np.float32)
    x[:, 0, 0, 0] = np.arange(n)
    y = np.arange(n, dtype=np.int32) % 10
    got, want = [], []
    _record_steps(monkeypatch, tengine, got)
    _record_steps(monkeypatch, jengine, want)
    tengine.train(torch.nn.Linear(1, 1), None, (x, y), epochs=epoch + 1,
                  batch_size=bs)
    jengine.train(None, None, (x, y), epochs=epoch + 1, batch_size=bs)
    per = n // bs
    assert len(got) == len(want) == per * (epoch + 1)
    assert got == want
    old = [xb[:, 0, 0, 0].astype(int).tolist()
           for xb, _ in tdata.batches(x, y, bs, seed=epoch)]
    assert old != want[epoch * per:]


def test_one_epoch_of_train_ends_at_the_jax_weights(monkeypatch):
    """One epoch (4 Adam steps) of each engine's ``train`` on a Bayesian
    linear model at sigma = softplus(-30): the noise is 1e-13 of the
    weights, so the steps are decided by the batches, and the port ends
    at the JAX weights (1e-5). The same steps in the old order end
    elsewhere."""
    import jax.numpy as jnp
    from flax import nnx

    from bayesian_torch_tpu.examples import _engine as jengine
    from bayesian_torch_tpu.layers import LinearReparameterization as JLin
    from bayesian_torch_tpu_torch.examples import _data as tdata
    from bayesian_torch_tpu_torch.examples import _engine as tengine
    from bayesian_torch_tpu_torch.layers import LinearReparameterization

    rs = np.random.RandomState(11)
    x = rs.randn(64, 6).astype(np.float32)
    y = (x[:, :3].argmax(1) + (rs.rand(64) < 0.3)).astype(np.int32) % 3
    arrays = {"mu_weight": rs.randn(3, 6).astype(np.float32) * 0.5,
              "rho_weight": np.full((3, 6), -30.0, np.float32),
              "mu_bias": rs.randn(3).astype(np.float32) * 0.1,
              "rho_bias": np.full((3,), -30.0, np.float32)}

    def port_model():
        m = LinearReparameterization(6, 3)
        m.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in arrays.items()}, strict=False)
        return m.train()

    jm = JLin(6, 3, rngs=nnx.Rngs(params=0, noise=1))
    for k, v in arrays.items():
        getattr(jm, k)[...] = jnp.asarray(v)
    jengine.train(jm, jengine.make_optimizer(jm, 0.05, "adam"), (x, y),
                  epochs=1, batch_size=16)
    tm = port_model()
    tengine.train(tm, tengine.make_optimizer(tm, 0.05, "adam"), (x, y),
                  epochs=1, batch_size=16)
    for k in arrays:
        np.testing.assert_allclose(getattr(tm, k).detach().numpy(),
                                   np.asarray(getattr(jm, k)[...]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # the old order: the same four steps on other batches
    old = port_model()
    monkeypatch.setattr(tengine, "DataLoader", lambda x, y, batch_size: type(
        "Old", (), {"epoch": staticmethod(lambda e: tdata.batches(
            x, y, batch_size, seed=e))})())
    tengine.train(old, tengine.make_optimizer(old, 0.05, "adam"), (x, y),
                  epochs=1, batch_size=16)
    moved = float(np.abs(old.mu_weight.detach().numpy()
                         - np.asarray(jm.mu_weight[...])).max())
    assert moved > 1e-3, moved
