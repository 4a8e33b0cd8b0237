"""The port's multi-process modules (``bayesian_torch_tpu_torch.parallel``:
``make_mesh``, ``shard_batch``, ``replicate``, ``initialize``,
``shard_params_tp``, ``mc_forward(mesh=)``), the trainers' ``--mesh-mc``
and ``graft_entry.dryrun_multichip``, on the CPU: each multi-rank case
spawns 2, 4 or 8 gloo ranks (``tests/_torch_port_ranks.py``: one thread
a rank, a wall-clock limit, the children killed on failure), and every
rank holds its result against the same work in one process.

- The JAX package's cases: the mesh's construction and errors
  (tests/test_parallel.py, tests/test_tp.py), ``initialize`` in one
  process, two processes summing 1 + 2, a bad coordinator raising
  (tests/test_distributed.py), and ``shard_params_tp`` (tests/test_tp.py).
- ``mc_forward(mesh=)`` against ``mc_forward`` at the same seed, through
  the draw loop and the vmap emission, eval and training, ``reduce=
  "mean"``, Flipout and Dropout: bit for bit in f32 in eval with only
  'mc' sharded; within 1e-6 with 'data' sharded (a smaller batch may sum
  in another order); in training the gradients after ``reduce_gradients``
  within 1e-5 of the largest gradient of the model, and the BatchNorm
  running statistics within 1e-5.
- Tensor parallelism against the JAX package's, on its 8-device virtual
  mesh, with the same seeded non-zero noise injected (1e-5), and the
  count ``shard_params_tp`` returns on the same models, resnet20 included;
  ``LinearReparameterization(impl="pallas")`` among them (ROADMAP F13).
- The head on the fused sampled GEMM (``impl="pallas"``) under ``mc=2``,
  ``data=2`` and both, through the loop and the vmap emission, eval and
  training: a rank's lanes of K-B, K-D and K-E are those of one process.
- The counter window of the samplers' plain versions (K-A, K-C): a
  window's lanes are those lanes of the whole launch, element for element.
- The Bayesian LSTM (the time-series trainer's regressor, both estimators
  and the ``bnn_to_qbnn`` form) under ``mc=2`` and ``data=2``, through the
  loop and the vmap emission, eval and training, to the thresholds of the
  small net; under ``shard_params_tp`` against the replicated model, with
  JAX's count; the JAX LSTM under the virtual mesh against no mesh.
- The bf16 vmap step over two ranks of draws (ROADMAP F10 on the CPU).
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from bayesian_torch_tpu_torch.parallel import (initialize, make_mesh,
                                               shard_params_tp)
from tests._torch_port_ranks import spawn


# --- the mesh ---------------------------------------------------------------


def test_mesh_construction_and_errors():
    """tests/test_parallel.py::test_mesh_construction: the shape, and the
    errors for an axis that does not divide the ranks; one process is a
    mesh of one rank."""
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(mc=3, devices=list(range(8)))
    with pytest.raises(ValueError, match="!= 8 devices"):
        make_mesh(mc=2, data=2, model=1, devices=list(range(8)))
    mesh = make_mesh()
    assert mesh.shape == {"mc": 1, "data": 1} and mesh.is_first
    assert mesh.group("mc", "data") is None  # nothing to talk to


def test_mesh_layout_over_four_ranks():
    """Ranks take the coordinates of ``np.arange(4).reshape(2, 2)``
    (tests/test_tp.py::test_mesh_with_model_axis for the 'model' axis);
    ``shard_batch`` gives each its 'data' block; ``replicate`` makes every
    rank's parameters, buffers and generators rank 0's."""
    res = spawn("mesh_layout", 4)
    grid = np.arange(4).reshape(2, 2)
    tp_grid = np.arange(4).reshape(2, 1, 2)
    for rank, r in enumerate(res):
        assert r["shape"] == {"mc": 2, "data": 2}
        (m, d), = np.argwhere(grid == rank)
        assert r["coords"] == {"mc": m, "data": d}
        assert r["groups"] == {"mc": 2, "data": 2, "all": 4}
        assert r["block"] == list(range(d * 6, d * 6 + 6))
        assert r["tp_shape"] == {"mc": 2, "data": 1, "model": 2}
        (m, d, k), = np.argwhere(tp_grid == rank)
        assert r["tp_coords"] == {"mc": m, "data": d, "model": k}
        assert r["replicated"] and r["generator"]


# --- initialize ---------------------------------------------------------------


def test_initialize_single_process():
    """No coordinator and no torchrun environment: a logged no-op; the
    devices a mesh can span are the visible cards, 1 on the CPU."""
    import torch.distributed as dist

    assert initialize() == 1
    assert not dist.is_initialized()


def test_two_process_distributed_psum():
    """Two processes join one world with explicit arguments and sum
    1 + 2 (gloo on the CPU)."""
    assert spawn("psum", 2) == [(3.0, "gloo"), (3.0, "gloo")]


def test_initialize_reads_torchrun_environment():
    """Without arguments, ``initialize`` joins the world torchrun
    describes (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
    and returns its size."""
    import os

    from tests._torch_port_ranks import ROOT, _free_port

    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from bayesian_torch_tpu_torch.parallel import initialize
        n = initialize()
        t = torch.tensor([dist.get_rank() + 1.0])
        dist.all_reduce(t)
        print("SUM", float(t), n, dist.get_backend())
        dist.destroy_process_group()
    """)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), PYTHONPATH=ROOT))
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out in outs:
        assert "SUM 3.0 2 gloo" in out, out


def test_explicit_bad_coordinator_raises():
    """Explicit arguments that fail raise, within the timeout asked for."""
    code = textwrap.dedent("""
        import time
        from bayesian_torch_tpu_torch.parallel import initialize
        t0 = time.monotonic()
        try:
            initialize("127.0.0.1:1", num_processes=2, process_id=1,
                       initialization_timeout=3)
        except Exception as e:
            print("RAISED", type(e).__name__, round(time.monotonic() - t0))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert "RAISED" in out.stdout, out.stdout + out.stderr
    assert int(out.stdout.split()[-1]) < 60


def test_backend_rule(monkeypatch):
    """NCCL when each rank of the host has a card of its own; gloo on the
    CPU and when a host runs more ranks than cards."""
    from bayesian_torch_tpu_torch.parallel import distributed

    assert distributed.backend_for(1) == "gloo"  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.backend_for(1) == "nccl"
    assert distributed.backend_for(2) == "gloo"  # two ranks, one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.backend_for(4) == "nccl"


# --- mc_forward(mesh=) --------------------------------------------------------

REP, FLIP = "reparameterization", "flipout"
PARITY = [
    # (mc, data, mc_forward keywords, training, estimator, dropout)
    (2, 1, {"emission": "scan"}, False, REP, 0.0),
    (2, 1, {"emission": "vmap"}, False, REP, 0.0),
    (2, 1, {"emission": "scan", "reduce": "mean"}, False, FLIP, 0.0),
    (2, 1, {"emission": "vmap", "reduce": "mean"}, False, FLIP, 0.0),
    (2, 1, {"emission": "scan"}, True, REP, 0.3),
    (2, 1, {"emission": "vmap"}, True, FLIP, 0.0),
    (2, 1, {"emission": "vmap", "reduce": "mean"}, True, REP, 0.0),
    (2, 2, {"emission": "scan"}, False, FLIP, 0.0),
    (2, 2, {"emission": "vmap", "reduce": "mean"}, False, REP, 0.0),
    (2, 2, {"emission": "scan"}, True, FLIP, 0.0),
    (2, 2, {"emission": "vmap"}, True, REP, 0.3),
    (1, 2, {"emission": "vmap"}, True, REP, 0.0),
]


@pytest.mark.parametrize("mc,data,kw,training,estimator,dropout", PARITY)
def test_mc_forward_mesh_equals_one_process(mc, data, kw, training,
                                            estimator, dropout):
    """Conv -> BatchNorm -> ReLU -> Dropout -> Linear, MC-4 on 8 rows,
    two steps: every rank returns the one-process outputs and KL, and
    after ``reduce_gradients`` its gradients; the generators end where
    one process leaves them."""
    res = spawn("mc_parity", mc * data, mc, data, 4, kw, training,
                estimator, dropout, 2)
    shape = (8, 5) if kw.get("reduce") == "mean" else (4, 8, 5)
    for r in res:
        assert r["shape"] == shape and r["generators"]
        if data == 1 and not training:
            assert r["outs"] == 0.0 and r["kl"] == 0.0, r
        assert r["outs"] <= 1e-6 and r["kl"] <= 1e-6, r
        assert r["grad"] <= 1e-5 and r["stats"] <= 1e-5, r


# (mc, data, emission): the small net's head at impl="pallas" (the fused
# sampled GEMM), eval and the f32 training step, each over its world
PALLAS_PARITY = [(mc, data, emission) for mc, data in ((2, 1), (1, 2), (2, 2))
                 for emission in ("scan", "vmap")]


@pytest.mark.parametrize("mc,data,emission", PALLAS_PARITY)
def test_mc_forward_mesh_pallas_head_equals_one_process(mc, data, emission):
    """``test_mc_forward_mesh_equals_one_process`` with the head on the
    fused sampled GEMM, MC-4, two steps, in eval and in training: a rank
    that computes draws [s0, s1) of the vmap emission runs K-B (and K-D,
    K-E in the backward) on lanes [s0, s1) of the one-process launch and
    the bias sampler on the same lanes, so outputs and KL equal one
    process bit for bit with only 'mc' sharded, else within 1e-6; the
    gradients within 1e-5 of the largest after ``reduce_gradients``."""
    cases = [(mc, data, 4, {"emission": emission}, training, REP, 0.0, 2,
              False, "NCHW", False, 1, "pallas")
             for training in (False, True)]
    for rank in spawn("in_turn", mc * data, "mc_parity", cases):
        for case, r in zip(cases, rank):
            assert r["shape"] == (4, 8, 5) and r["generators"], (case, r)
            if data == 1:
                assert r["outs"] == 0.0 and r["kl"] == 0.0, (case, r)
            assert r["outs"] <= 1e-6 and r["kl"] <= 1e-6, (case, r)
            assert r["grad"] <= 1e-5 and r["stats"] <= 1e-5, (case, r)


def test_sharded_mc_forward_runs():
    """tests/test_parallel.py::test_sharded_mc_forward_runs: an
    (mc=4, data=2) mesh over 8 ranks, MC-4; each rank returns the whole
    (4, 8, 5) stack, the one-process stack of the emission "auto" takes
    under a mesh (vmap)."""
    for r in spawn("mc_parity", 8, 4, 2, 4, {"emission": "vmap"}, False,
                   REP):
        assert r["shape"] == (4, 8, 5) and r["outs"] <= 1e-6, r


def test_mc_forward_mesh_refuses_an_uneven_split():
    res = spawn("mc_parity_error", 2, 3)
    assert all("do not divide over the mesh's 'mc' axis of 2" in e
               for e in res)


def test_bf16_vmap_step_over_two_draw_ranks():
    """Both estimators' MC-4 vmap step of ``test_mc_forward_mesh_equals_one_process``
    with every layer computing in bf16, at ``mc=2``: outputs and KL equal
    one process bit for bit; the gradients within two bf16 ulps (2**-7) of
    the model's largest. A weight gradient that a bf16 product sums over
    the batch is rounded to bf16 once a rank before ``reduce_gradients``
    adds them: Flipout's shared mean weight, summed over each rank's two
    lanes of rows, differs by one ulp (2**-8 measured); reparameterization,
    a weight a lane, agrees to 6e-8."""
    cases = [(2, 1, 4, {"emission": "vmap"}, True, estimator, 0.0, 2,
              True) for estimator in (REP, FLIP)]
    for rank in spawn("in_turn", 2, "mc_parity", cases):
        for r in rank:
            assert r["outs"] == 0.0 and r["kl"] == 0.0, r
            assert r["grad"] <= 2 ** -7 and r["stats"] <= 1e-5, r
            assert r["generators"], r


# --- the Bayesian LSTM under a mesh ----------------------------------------------

LREP, LFLIP = "Reparameterization", "Flipout"
LSTM_PARITY = [
    # (mc, data, mc_forward keywords, training, estimator, quantized,
    #  a whole-batch initial state)
    (2, 1, {"emission": "vmap"}, False, LREP, False, False),
    (2, 1, {"emission": "scan"}, True, LFLIP, False, False),
    (1, 2, {"emission": "vmap"}, True, LREP, False, True),
    (2, 1, {"emission": "scan", "presample": "hash"}, False, LREP, True,
     False),
    (2, 1, {"emission": "vmap"}, False, LFLIP, True, False),
    (2, 2, {"emission": "vmap"}, True, LFLIP, False, True),
    (1, 2, {"emission": "scan"}, False, LREP, True, True),
]


@pytest.mark.parametrize("world", [2, 4])
def test_lstm_mc_forward_mesh_equals_one_process(world):
    """The regressor (LSTM(1 -> 6) + Linear(6 -> 2)), MC-4 on 8 rows of 5
    steps, two steps, at each setting of ``LSTM_PARITY`` over ``world``
    ranks (in turn, in one world): every rank returns the one-process
    outputs and KL (bit for bit in eval with only 'mc' sharded, else
    within 1e-6) and, after ``reduce_gradients``, its gradients within
    1e-5 of the largest; the generators end where one process leaves
    them. Under the vmap emission a rank draws its draws' T lanes of each
    K-A launch and its block of the signs; the loop runs every draw on
    every rank (the LSTM draws inside each forward); the quantized cell
    draws its block of the normals; a whole-batch initial state gives each
    rank its rows."""
    cases = [(mc, data, 4) + tuple(rest) for mc, data, *rest in LSTM_PARITY
             if mc * data == world]
    for rank in spawn("in_turn", world, "lstm_parity", cases):
        for case, r in zip(cases, rank):
            mc, data, _, kw, training = case[:5]
            assert r["shape"] == (4, 8, 5, 2) and r["generators"], case
            if data == 1 and not training:
                assert r["outs"] == 0.0 and r["kl"] == 0.0, (case, r)
            assert r["outs"] <= 1e-6 and r["kl"] <= 1e-6, (case, r)
            assert r["grad"] <= 1e-5, (case, r)


class _JaxLast(nnx.Module):
    """The JAX twin of ``tests/_torch_port_ranks.py::LastStep``."""

    def __init__(self, lstm):
        self.lstm = lstm

    def __call__(self, x):
        h_seq, _, kl = self.lstm(x)
        return h_seq[:, -1], kl


def _jax_lstm(estimator, seed=0):
    import bayesian_torch_tpu.layers as jl

    return _JaxLast(getattr(jl, "LSTM" + estimator)(
        3, 8, rngs=nnx.Rngs(params=seed, noise=seed + 1)))


def test_jax_lstm_under_the_virtual_mesh_equals_no_mesh():
    """The reference side: the JAX LSTM (last step of LSTM(3 -> 8)) under
    ``make_mesh(mc=4, data=2)`` of the 8 virtual devices gives what it
    gives without a mesh, outputs and KL, in both estimators; so the port's
    rule (every rank gets the one-process result) is JAX's."""
    from bayesian_torch_tpu.parallel import make_mesh as jmake_mesh
    from bayesian_torch_tpu.parallel import mc_forward as jmc_forward

    x = jnp.asarray(np.random.RandomState(81).randn(4, 5, 3)
                    .astype(np.float32))
    mesh = jmake_mesh(mc=4, data=2)
    for estimator in ("Reparameterization", "Flipout"):
        want, kl_want = jmc_forward(_jax_lstm(estimator), x, 4)
        with mesh:
            got, kl_got = jmc_forward(_jax_lstm(estimator), x, 4, mesh=mesh)
        assert got.shape == (4, 4, 8)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=1e-6)
        assert float(kl_got) == pytest.approx(float(kl_want), rel=1e-6)


def test_tp_lstm_equals_replicated_with_jax_count():
    """``shard_params_tp`` over 'model' = 2 on LSTM(3 -> 8) (its last
    step), both estimators: the count equals JAX's on the same model (8:
    both blocks' posteriors), each block keeps half of its 4H rows, and
    the sharded LSTM (its blocks gathered at each forward, the replicated
    cell) equals the replicated one: outputs drawn from the generator, the
    vmap emission's outputs and gradients (each rank its rows), the draw
    loop, and the KL inside and outside the forward."""
    from bayesian_torch_tpu.parallel import make_mesh as jmake_mesh
    from bayesian_torch_tpu.parallel import shard_params_tp as jshard

    mesh = jmake_mesh(mc=1, data=4, model=2)
    want = {jshard(_jax_lstm(est), mesh)
            for est in ("Reparameterization", "Flipout")}
    x = np.random.RandomState(82).randn(2, 5, 3).astype(np.float32)
    results = spawn("in_turn", 2, "tp_parity", [
        (kind, {}, x, {}) for kind in ("lstm", "lstm_flipout")])
    for r in (r for rank in results for r in rank):
        assert want == {r["count"]} == {8}
        assert r["shapes"]["lstm.hh.mu_weight"] == (16, 8)
        assert r["injected"] == 0.0 and r["injected_kl"] <= 1e-5, r
        assert r["drawn"] <= 1e-6 and r["vmap"] <= 1e-6, r
        assert r["grad"] <= 1e-5 and r["loop"] <= 1e-6, r
        assert r["kl_call"] <= 1e-5, r


# --- tensor parallelism ---------------------------------------------------------

TP_KINDS = {
    "linear": ((16, 8), "eps_w", (2, 16)),
    # the fused sampled GEMM: the JAX layer takes its XLA path on injected
    # noise; the port's shard draws its rows' window (ROADMAP F13)
    "linear_pallas": ((16, 8), "eps_w", (2, 16)),
    "conv": ((8, 16, 3), "eps_k", (2, 8, 5, 5)),
    "convT": ((4, 8, 3), "eps_k", (2, 4, 5, 5)),
}


def _jax_layer(kind):
    from bayesian_torch_tpu.layers import (Conv2dReparameterization,
                                           ConvTranspose2dReparameterization,
                                           LinearReparameterization)

    args, _, _ = TP_KINDS[kind]
    cls = {"linear": LinearReparameterization,
           "linear_pallas": LinearReparameterization,
           "conv": Conv2dReparameterization,
           "convT": ConvTranspose2dReparameterization}[kind]
    kw = {"padding": 1} if kind == "conv" else {}
    if kind == "linear_pallas":
        kw = {"impl": "pallas"}
    return cls(*args, **kw, rngs=nnx.Rngs(params=0, noise=1))


@pytest.mark.parametrize("kind", sorted(TP_KINDS))
def test_tp_layer_equals_jax_tp(kind):
    """The layer sharded over 'model' = 2 against the JAX layer sharded
    over 'model' = 2 of the virtual 8-device mesh, both with the same
    random weights and the same non-zero noise injected: the outputs
    within 1e-5, the KL within 1e-5 relative, the count equal; the
    port's sharded layer also equals its replicated twin with noise drawn
    from the generator, under the vmap emission in training, in its
    output and its gradients, and through the draw loop's presample."""
    from bayesian_torch_tpu.parallel import make_mesh as jmake_mesh
    from bayesian_torch_tpu.parallel import shard_params_tp as jshard

    _, eps_name, x_shape = TP_KINDS[kind]
    rs = np.random.RandomState(3)
    jm = _jax_layer(kind)
    arrays = {}
    for name in ("mu_weight", "rho_weight", "mu_kernel", "rho_kernel",
                 "mu_bias", "rho_bias"):
        if hasattr(jm, name):
            shape = getattr(jm, name)[...].shape
            v = (rs.normal(-3.0, 0.3, shape) if name.startswith("rho")
                 else rs.normal(0.0, 0.3, shape)).astype(np.float32)
            getattr(jm, name)[...] = jnp.asarray(v)
            arrays[name] = v
    weight = "mu_weight" if kind.startswith("linear") else "mu_kernel"
    eps = {eps_name: rs.randn(*arrays[weight].shape).astype(np.float32),
           "eps_b": rs.randn(*arrays["mu_bias"].shape).astype(np.float32)}
    x = rs.randn(*x_shape).astype(np.float32)
    mesh = jmake_mesh(mc=1, data=4, model=2)
    count = jshard(jm, mesh)
    jeps = {k: jnp.asarray(v) for k, v in eps.items()}

    @nnx.jit
    def run(m, x):
        return m(x, **jeps)

    with mesh:
        want, want_kl = run(jm, jnp.asarray(x))
    res = spawn("tp_parity", 2, kind, arrays, x, eps)
    got = res[0]
    assert got["count"] == count == 4
    np.testing.assert_allclose(got["out"], np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["kl"], float(want_kl), rtol=1e-5)
    for r in res:
        assert r["injected"] <= 1e-6 and r["drawn"] <= 1e-6, r
        assert r["vmap"] <= 1e-6 and r["grad"] <= 1e-5, r
        assert r["loop"] <= 1e-6, r


@pytest.mark.parametrize("kind", ["conv_flipout", "linear_flipout"])
def test_tp_flipout_layer_equals_replicated(kind):
    """Flipout's signs: a shard takes its channels of the whole output's
    signs, so the sharded layer gives the replicated layer's output."""
    for r in spawn("tp_parity", 2, kind, {}, np.random.RandomState(4).randn(
            2, *((16,) if kind.startswith("linear") else (8, 5, 5))).astype(
                np.float32), {}):
        assert r["count"] == 4
        assert r["drawn"] <= 1e-6 and r["vmap"] <= 1e-6, r
        assert r["grad"] <= 1e-5 and r["loop"] <= 1e-6, r


def test_shard_params_tp_counts_equal_jax():
    """The count on each model equals the JAX count on its twin (an
    indivisible out dim stays replicated); a deterministic ``nn.Linear``
    shards its weight and bias; resnet20 sharded over 'model' = 2 gives
    the replicated logits in eval (presampled draws) and in training."""
    from bayesian_torch_tpu.layers import (BatchNorm2dLayer,
                                           LinearReparameterization)
    from bayesian_torch_tpu.models.bayesian.resnet_variational import (
        resnet20,
    )
    from bayesian_torch_tpu.parallel import make_mesh as jmake_mesh
    from bayesian_torch_tpu.parallel import shard_params_tp as jshard

    mesh = jmake_mesh(mc=1, data=4, model=2)
    rngs = lambda: nnx.Rngs(params=0, noise=1)  # noqa: E731
    jax_models = {
        "linear": lambda: _jax_layer("linear"),
        "conv": lambda: _jax_layer("conv"),
        "convT": lambda: _jax_layer("convT"),
        "odd_linear": lambda: LinearReparameterization(16, 7, rngs=rngs()),
        "bn": lambda: BatchNorm2dLayer(8, rngs=rngs()),
        "resnet20": lambda: resnet20(rngs=rngs()),
    }
    want = {name: jshard(build(), mesh) for name, build in jax_models.items()}
    counts, diffs = spawn("tp_counts", 2)[0]
    assert {k: counts[k] for k in want} == want
    assert counts["nn_linear"] == 2
    assert want["resnet20"] > 0 and want["odd_linear"] == 0
    assert diffs["eval"] <= 1e-5 and diffs["train"] <= 1e-5, diffs


def test_shard_params_tp_on_one_rank_counts_and_leaves_the_layer():
    """A 'model' axis of 1 counts what a larger one would shard and
    changes nothing."""
    from bayesian_torch_tpu_torch.layers import LinearReparameterization

    layer = LinearReparameterization(16, 8)
    before = {k: v.clone() for k, v in layer.state_dict().items()}
    assert shard_params_tp(layer, make_mesh(), axis="data") == 4
    for k, v in layer.state_dict().items():
        assert torch.equal(v, before[k])
    assert not hasattr(layer, "_tp")


# --- the samplers' counter window -----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_lanes_equal_the_whole_launch(dtype):
    """K-A's and K-C's plain versions under a window (lane0, lane stride,
    offset): lanes [2, 5) of a 5-lane launch, and rows [r n_r, (r+1) n_r)
    of each lane, are those of the whole launch element for element."""
    gen = torch.Generator().manual_seed(0)
    n, S, seed = 24, 5, 1234567
    mu = torch.randn(n, generator=gen).to(dtype)
    sigma = torch.rand(n, generator=gen).to(dtype)
    rho = torch.randn(n, generator=gen).to(dtype)
    whole = ka.sample_scaled_normals_batch_plain(seed, mu, sigma, S, dtype)
    lanes = ka.sample_scaled_normals_batch_plain(seed, mu, sigma, 3, dtype,
                                                 window=(2, n, 0))
    assert torch.equal(lanes, whole[2:])
    for r in range(3):  # a dim-0 shard of 8 of the 24 elements
        part = slice(8 * r, 8 * r + 8)
        got = ka.sample_scaled_normals_batch_plain(
            seed, mu[part], sigma[part], 2, dtype, window=(3, n, 8 * r))
        assert torch.equal(got, whole[3:, part])
        g = torch.randn((2, 8), generator=gen)
        placed = torch.zeros((S, n))
        placed[3:, part] = g  # the same cotangent in the whole launch
        assert torch.equal(ka.dsigma_plain(seed, g, window=(3, n, 8 * r)),
                           ka.dsigma_plain(seed, placed)[part])
        one = ka.sample_gaussian(seed, mu[part], rho[part], dtype,
                                 window=(0, n, 8 * r))
        assert torch.equal(one, ka.sample_gaussian(seed, mu, rho,
                                                   dtype)[part])
        g1 = torch.randn(8, generator=gen)
        placed1 = torch.zeros(n)
        placed1[part] = g1
        assert torch.equal(
            ka.drho_plain(seed, g1, rho[part], window=(0, n, 8 * r)),
            ka.drho_plain(seed, placed1, rho)[part])
    with pytest.raises(ValueError, match="does not hold"):
        ka.sample_scaled_normals_batch(seed, mu[:8], sigma[:8], 1,
                                       window=(0, n, 20))


# --- the trainers and the dry run -----------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_mnist_trainer_mesh_mc_equals_one_process(world, tmp_path):
    """``main_bayesian_mnist --mesh-mc=2 --device=cpu`` over 2 ranks (mc)
    and 4 (mc x data): every rank ends with the one-process weights
    (1e-5) and accuracy, and only rank 0 writes files."""
    from tests._torch_port_ranks import run_mnist_trainer

    argv = ["--synthetic", "--device=cpu", "--batch-size=16",
            "--test-batch-size=16", "--epochs=1", "--num_mc=2",
            "--num_monte_carlo=4"]
    want_metrics, want = run_mnist_trainer(
        argv + [f"--save_dir={tmp_path / 'one'}"])
    res = spawn("trainer_run", world, str(tmp_path), argv + ["--mesh-mc=2"])
    assert res[0]["files"] == ["last.pt", "mnist_bayesian_scnn.pt",
                               "mnist_metrics.json"]
    for r in res:
        assert r["metrics"]["accuracy"] == want_metrics["accuracy"]
        for k, v in want.items():
            np.testing.assert_allclose(r["state"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(r["state"][k], res[0]["state"][k])
    assert all(r["files"] == [] for r in res[1:])


def test_dryrun_multichip_four_ranks():
    """The twin of ``__graft_entry__.dryrun_multichip(4)``: the JAX
    choice of mesh for 4 (mc 2, data 2), one resnet20 training step, the
    INT8 QBNN, the structured Flipout forward and the draw loop, each
    equal to one process."""
    from bayesian_torch_tpu_torch.graft_entry import dryrun_multichip

    res = dryrun_multichip(4, device="cpu", timeout=300)
    assert res["mesh"] == {"mc": 2, "data": 2} and res["tp_sharded"] == 0
    assert abs(res["loss"] - res["loss_one_process"]) <= 1e-5
    assert res["param_diff"] <= 1e-5 and res["int8_qbnn"] <= 1e-5
    assert res["structured_flipout"] <= 1e-5
    assert res["scan_emission"] <= 1e-5
