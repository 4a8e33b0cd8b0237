"""Block remat and ``mc_forward(remat_policy=...)`` with replayed draws
(``ops/remat.py``, ``LargeResNet(remat_blocks=...)``), against the port
without remat and against JAX ``remat_blocks=True``.

The fixture is JAX's (``tests/test_remat.py::_build``): a
``LargeResNet(BasicBlock, [1, 1, 1, 1])`` with 4 classes at 16x16, here in
NCHW. On the CPU a recomputed block runs the same torch ops on the same
draws, so remat must change nothing: the loss, every gradient, the BN
running statistics, ``num_batches_tracked`` and the generators' streams
after the step equal the step without remat exactly. Against JAX the draws
are injected (``tests/_torch_port.py::inject_draws``) and the tolerance is
1e-4, as in the other ELBO-step parity tests; that comparison runs at
64x64, because at 16x16 layer4's BatchNorm sees two values a channel and
JAX's one-pass variance, E[x^2] - E[x]^2, cancels there (the two packages
then differ by 0.5 in 7 at rho = -30, without remat too; at 64x64 by
2.6e-5).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from bayesian_torch_tpu.parallel import mc as jmc
from bayesian_torch_tpu.utils.checkpoint import (_torch_key_for,
                                                 import_torch_state_dict)
from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.models._large_resnet import (BasicBlock,
                                                           LargeResNet)
from bayesian_torch_tpu_torch.ops import remat
from bayesian_torch_tpu_torch.ops.sampling import module_generators
from bayesian_torch_tpu_torch.parallel import mc as tmc
from tests._torch_port import (FLIPOUT, REPARAM, draw_noise, inject_draws,
                               jax_arrays, random_state, set_jax_eval, to_np)

B = 2
TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(seed=7, size=16):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(B, 3, size, size).astype(np.float32)),
            torch.tensor([1, 3]))


def _build(remat_blocks, estimator, seed=0):
    model = LargeResNet(BasicBlock, [1, 1, 1, 1], num_classes=4,
                        estimator=estimator, remat_blocks=remat_blocks,
                        generator=torch.Generator().manual_seed(seed))
    return model.train()


def _step(model, num_mc, emission, remat_policy=None):
    """The JAX test's loss (CE of the mean over draws + KL / B), one
    backward; returns (loss, grads, buffers, the generators' states)."""
    x, y = _batch()
    if model.estimator is None:
        loss = torch.nn.functional.cross_entropy(model(x), y)
    else:
        outs, kl = tmc.mc_forward(model, x, num_mc, emission=emission,
                                  remat_policy=remat_policy)
        loss = torch.nn.functional.cross_entropy(outs.mean(0), y) + kl / B
    loss.backward()
    return (loss.detach(),
            {n: p.grad for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()},
            [g.get_state() for g in module_generators(model)])


def _assert_same_step(got, want):
    assert torch.equal(got[0], want[0])
    for part in (1, 2):
        assert set(got[part]) == set(want[part])
        for name in want[part]:
            assert torch.equal(got[part][name], want[part][name]), name
    assert len(got[3]) == len(want[3])  # one shared, or none (det)
    for a, b in zip(got[3], want[3]):
        assert torch.equal(a, b)


CASES = [(None, 1, "scan")] + [
    (est, num_mc, emission) for est in (REPARAM, FLIPOUT)
    for num_mc, emission in ((1, "scan"), (2, "scan"), (2, "vmap"))]


@pytest.mark.parametrize("estimator,num_mc,emission", CASES)
def test_remat_blocks_equal_no_remat(estimator, num_mc, emission):
    want = _step(_build(False, estimator), num_mc, emission)
    for remat_blocks in (True, "conv_out"):
        got = _step(_build(remat_blocks, estimator), num_mc, emission)
        _assert_same_step(got, want)
        assert int(got[2]["bn1.num_batches_tracked"]) == 1


@pytest.mark.parametrize("estimator,policy", [
    (REPARAM, "full"), (FLIPOUT, "conv_out"), (REPARAM, "callable")])
def test_remat_policy_under_the_loop_equals_no_remat(estimator, policy):
    """Each draw's forward behind a checkpoint (the loop keeps the KL in
    its last draw, so ``compute_kl`` is replayed per draw too)."""
    seen = []
    if policy == "callable":
        def policy(ctx, op, *args, **kwargs):
            seen.append(op)
            return remat.conv_out_policy(ctx, op, *args, **kwargs)
    want = _step(_build(False, estimator), 2, "scan")
    got = _step(_build(False, estimator), 2, "scan", remat_policy=policy)
    _assert_same_step(got, want)
    if seen:
        assert torch.ops.aten.convolution.default in seen


def test_remat_policy_under_vmap_and_bad_values():
    want = _step(_build(False, REPARAM), 2, "vmap")
    got = _step(_build(False, REPARAM), 2, "vmap", remat_policy="full")
    _assert_same_step(got, want)
    with pytest.raises(ValueError, match="remat policy"):
        tmc.mc_forward(_build(False, REPARAM), _batch()[0], 2,
                       remat_policy="sometimes")
    with pytest.raises(ValueError, match="remat_blocks"):
        _build("everything", REPARAM)


def test_conv_out_policy_sees_every_conv_of_the_blocks():
    """Under "conv_out" the policy marks the output of every conv inside
    the blocks to be saved (the selective checkpoint's cache serves them
    in the recompute)."""
    model = _build("conv_out", REPARAM)
    calls = []

    def counting(ctx, op, *args, **kwargs):
        if op in remat.CONV_OUT:
            calls.append(ctx.is_recompute)
        return remat.conv_out_policy(ctx, op, *args, **kwargs)

    real = remat.resolve_policy
    try:
        remat.resolve_policy = lambda p: counting if p == "conv_out" \
            else real(p)
        _step(model, 2, "vmap")
    finally:
        remat.resolve_policy = real
    # the four blocks' convs (two each, and three downsamples)
    assert calls == [False] * 11


def test_dropout_in_a_checkpointed_block_draws_the_same_mask():
    """A Dropout's mask comes from its generator: the recompute replays
    it, so the backward differentiates the forward's network; later draws
    see the stream they would have seen without the checkpoint."""
    from bayesian_torch_tpu_torch.layers import (Dropout,
                                                 LinearReparameterization)

    def block():
        gen = torch.Generator().manual_seed(5)
        return torch.nn.Sequential(
            LinearReparameterization(8, 16, generator=gen),
            Dropout(0.5, generator=gen),
        )

    def run(use_remat):
        torch.manual_seed(0)
        blk = block().train()
        masks = []
        blk[1].register_forward_hook(lambda m, i, o: masks.append(o[0] != 0))
        x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1),
                        requires_grad=True)

        def f(x):
            return blk(x)

        # the whole recompute, so that the hook sees the Dropout run again
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            out = remat.checkpoint(blk, f, x) if use_remat else f(x)
        out[0].square().sum().backward()
        after = torch.rand(6, generator=blk[1].generator)
        return masks, x.grad, blk[0].rho_weight.grad, after

    plain, again = run(False), run(True)
    assert len(plain[0]) == 1 and len(again[0]) == 2  # forward, recompute
    assert torch.equal(again[0][0], again[0][1])
    assert torch.equal(again[0][0], plain[0][0])
    for a, b in zip(plain[1:], again[1:]):
        assert torch.equal(a, b)


def test_generator_stream_after_a_remat_step():
    """After a remat step (the trainers' ``make_train_step``, SGD) the
    generator hands out what it hands out after a step without remat."""
    runs = []
    for blocks in (False, True):
        model = _build(blocks, FLIPOUT)
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        x, y = _batch(8)
        loss = engine.make_train_step(2, B, emission="vmap")(model, opt, x,
                                                             y)[0]
        runs.append((loss, torch.rand(8, generator=module_generators(
            model)[0])))
    (l0, r0), (l1, r1) = runs
    assert torch.equal(l0, l1) and torch.equal(r0, r1)


# --- against JAX remat_blocks=True ------------------------------------------


S = 2
LR = 0.05
JAX_SIZE = 64


def _jax_twin(seed):
    """The JAX fixture in NCHW with remat_blocks=True and its random
    weights; the port's twin holding the same weights."""
    from bayesian_torch_tpu.models._large_resnet import (
        BasicBlock as JBasicBlock,
        LargeResNet as JLargeResNet,
    )
    jm = JLargeResNet(JBasicBlock, [1, 1, 1, 1], num_classes=4,
                      estimator=REPARAM,
                      rngs=nnx.Rngs(params=seed, noise=seed + 1),
                      data_format="NCHW", remat_blocks=True)
    arrays = random_state(jax_arrays(jm), seed=seed)
    import_torch_state_dict(jm, arrays)
    set_jax_eval(jm, training=True)
    return jm, arrays


@pytest.fixture(scope="module")
def jax_remat_step():
    """One JAX ELBO step (vmap emission, presample on, draws injected) of
    the remat model, compiled; SGD(0.05, 0.9) applied."""
    mp = pytest.MonkeyPatch()
    try:
        jm, arrays = _jax_twin(seed=3)
        probe = _build(False, REPARAM)
        probe.load_state_dict({k: torch.from_numpy(v)
                               for k, v in arrays.items()})
        noise = draw_noise(probe, S, seed=4)
        inject_draws(mp, noise)
        x, y = (t.numpy() for t in _batch(9, JAX_SIZE))

        def loss_fn(model):
            outs, kl = jmc.mc_forward(model, jnp.asarray(x), S,
                                      presample="on", emission="vmap")
            ce = optax.softmax_cross_entropy_with_integer_labels(
                outs.mean(0), jnp.asarray(y)).mean()
            return ce + kl / B

        loss, grads = nnx.jit(nnx.value_and_grad(loss_fn))(jm)
        nnx.Optimizer(jm, optax.sgd(LR, 0.9), wrt=nnx.Param).update(jm,
                                                                     grads)
        grads = {_torch_key_for(p): np.asarray(v[...])
                 for p, v in nnx.to_flat_state(grads)}
        yield arrays, noise, float(loss), grads, jax_arrays(jm)
    finally:
        mp.undo()


@pytest.mark.parametrize("remat_blocks", [True, "conv_out"])
@pytest.mark.parametrize("emission", ["vmap", "scan"])
def test_remat_step_matches_jax_remat(monkeypatch, jax_remat_step,
                                      emission, remat_blocks):
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state

    arrays, noise, want_loss, want_grads, want_after = jax_remat_step
    inject_draws(monkeypatch, noise)
    tm = _build(remat_blocks, REPARAM)
    load_jax_state(tm, arrays)
    tm.train()
    x, y = _batch(9, JAX_SIZE)
    outs, kl = tmc.mc_forward(tm, x, S, presample="on", emission=emission)
    loss = torch.nn.functional.cross_entropy(outs.mean(0), y) + kl / B
    loss.backward()
    torch.optim.SGD(tm.parameters(), lr=LR, momentum=0.9).step()
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-4,
                                                 abs=1e-4)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(to_np(g), want_grads[name], err_msg=name,
                                   **TOL)
    for name, v in tm.state_dict().items():
        np.testing.assert_allclose(to_np(v), want_after[name], err_msg=name,
                                   **TOL)


# --- chip_smoke.py's launch arithmetic ------------------------------------


@pytest.mark.parametrize("emission", ["vmap", "scan"])
def test_chip_smoke_remat_launch_counts_match_a_step(monkeypatch, emission):
    """``chip_smoke.py`` phase 42 gates a remat step on the card by
    ``expected_remat_launches``: the step's own launches, and K-A once
    more for every draw of a layer inside a block (the recompute). Here
    the plain versions stand in for the kernels and bump their counters."""
    import chip_smoke as cs
    from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka

    for name, counter in (
            ("sample_scaled_normals_batch_plain",
             ka.sample_scaled_normals_batch),
            ("dsigma_plain", ka.dsigma), ("drho_plain", ka.drho)):
        def counted(*args, _fn=getattr(ka, name), _counter=counter, **kw):
            _counter.launches += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(ka, name, counted)
    model = _build(True, REPARAM)
    want = cs.expected_remat_launches(model, 2, emission == "vmap")
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    x, y = _batch(10)
    cs.reset_counts()
    engine.make_train_step(2, B, emission=emission)(model, opt, x, y)
    assert cs.counts() == want
    # 11 convs in the blocks, the stem conv and the head (weight and bias:
    # two draws a draw through the loop, one buffer under the draw axis),
    # and the blocks' 11 again in the recompute
    assert want["K-A"] == (13 + 11 if emission == "vmap" else 2 * (14 + 11))
