"""The port's example trainers, engine, data helpers and uncertainty
metrics (``bayesian_torch_tpu_torch/examples``, ``utils/util.py``,
``utils/checkpoint.py``) against the JAX package and against themselves:

- ``_data`` gives the JAX arrays for the same arguments;
- ``predictive_entropy`` / ``mutual_information`` equal the JAX functions;
- the ImageNet trainer (resnet18, 10 classes, batch 16, as
  tests/test_examples.py drives the JAX one, on 32x32 synthetic images)
  trains, resumes and tests, and 2 epochs run through equal 1 epoch plus
  a resumed one, bit for bit on the CPU (as tests/test_resume.py);
- the engine's ``train`` resumes the same way, ``evaluate`` refuses a
  test split smaller than one batch, and the unported flags raise;
- the deterministic trainer, the Bayesian trainer with ``--moped`` from
  its checkpoint, the ``dnn_to_bnn`` trainer and the INT8 pipeline run on
  resnet18 at 32x32: train, then test (INT8: float eval, then INT8 eval);
- the MNIST / CIFAR slice: ``load_mnist`` / ``load_cifar10`` give the JAX
  arrays (synthetic and from npz archives); the schedules equal optax's
  by optimizer step, and ``Adadelta`` equals ``optax.adadelta``;
  ``make_writer``; the six MNIST and CIFAR trainers and
  ``quantization_test`` end to end at ``--device=cpu`` on small synthetic
  sets (train, resume, test, ``--moped``, ``--mode=ptq``), each
  defaulting to ``cuda``.
"""

import json
import os

import numpy as np
import pytest
import torch

from bayesian_torch_tpu.examples import _data as jdata
from bayesian_torch_tpu.utils import util as jutil
from bayesian_torch_tpu_torch.examples import _data as tdata
from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples import main_bayesian_imagenet as trainer
from bayesian_torch_tpu_torch.ops.cuda import qmatmul as kf
from bayesian_torch_tpu_torch.ops.cuda import sampled_weights as ka
from bayesian_torch_tpu_torch.utils import util as tutil
from bayesian_torch_tpu_torch.utils.checkpoint import (
    load_training_checkpoint,
    save_training_checkpoint,
)
from tests._torch_port import TorchTiny


def test_data_helpers_give_the_jax_arrays():
    for kw in (dict(n=20, img=16, num_classes=10),
               dict(n=7, img=8, num_classes=3)):
        want = jdata.load_imagenet_val(synthetic=True, **kw)
        got = tdata.load_imagenet_val(synthetic=True, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    x, y = tdata.load_imagenet_val(synthetic=True, n=37, img=4,
                                   num_classes=5)
    for kw in (dict(seed=3), dict(shuffle=False), dict(drop_last=False)):
        got = list(tdata.batches(x, y, 8, **kw))
        want = list(jdata.batches(x, y, 8, **kw))
        assert len(got) == len(want) > 0
        for (xa, ya), (xb, yb) in zip(got, want):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


def test_uncertainty_metrics_equal_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(5, 7, 10).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for name in ("entropy", "predictive_entropy", "mutual_information"):
        want = getattr(jutil, name)(probs)
        got = getattr(tutil, name)(probs)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tutil.predictive_entropy(torch.from_numpy(probs)),
        jutil.predictive_entropy(probs))


def _small_imagenet(data_dir=None, synthetic=False, num_classes=1000):
    """The trainer's synthetic ImageNet at 32x32 and 80 images (64 to
    train, 16 to test), from the same generator."""
    return tdata._synthetic(80, (3, 32, 32), num_classes, 4, proto_seed=300)


def _run(save_dir, *extra):
    return trainer.main(["--arch=resnet18", "--num-classes=10",
                         "--batch-size=16", "--synthetic", "--device=cpu",
                         "--num_monte_carlo=2", f"--save_dir={save_dir}",
                         *extra])


def _final(save_dir):
    state = torch.load(os.path.join(save_dir, "imagenet_bayesian_resnet18.pt"),
                       weights_only=True)
    with open(os.path.join(save_dir, "imagenet_bayesian_metrics.json")) as f:
        metrics = json.load(f)
    metrics.pop("imgs_per_sec")
    return state, metrics


def test_trainer_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer, "load_imagenet_val", _small_imagenet)
    launches = ka.sample_scaled_normals_batch.launches
    whole, split = tmp_path / "whole", tmp_path / "split"
    _run(whole, "--epochs=2")
    _run(split, "--epochs=1")
    first = torch.load(split / "last.pt", weights_only=True)
    assert first["meta"] == {"epoch": 1, "best_acc": 0.0}
    assert set(first) == {"model", "opt", "meta", "rng_count"}
    _run(split, "--epochs=2", "--resume")
    (state_a, metrics_a), (state_b, metrics_b) = _final(whole), _final(split)
    assert set(state_a) == set(state_b)
    for key in state_a:
        assert torch.equal(state_a[key], state_b[key]), key
    assert metrics_a == metrics_b
    assert 0.0 <= metrics_a["accuracy"] <= 1.0
    tracked = state_a["layer1.0.bn1.num_batches_tracked"]
    assert int(tracked) == 8  # 2 epochs of 4 steps, one update each
    tested = _run(split, "--mode=test", "--epochs=2")
    assert set(tested) == set(metrics_a) | {"imgs_per_sec"}
    assert ka.sample_scaled_normals_batch.launches == launches  # CPU: plain


def test_trainer_refuses_unported_flags():
    """Only ``--mesh-mc`` above 1 is left to refuse; ``--remat`` and
    ``--structured-mc`` run (test_torch_port_modes.py)."""
    assert set(engine.UNPORTED) == {"mesh_mc"}
    with pytest.raises(NotImplementedError, match="#15"):
        trainer.main(["--synthetic", "--device=cpu", "--mesh-mc=2"])
    engine.refuse_unported(trainer.build_parser().parse_args(
        ["--remat", "--structured-mc"]))


COMMON = ["--arch=resnet18", "--num-classes=10", "--batch-size=16",
          "--synthetic", "--device=cpu"]


@pytest.fixture
def trainers(monkeypatch):
    from bayesian_torch_tpu_torch.examples import (
        main_bayesian_imagenet_bnn2qbnn,
        main_bayesian_imagenet_dnn2bnn,
        main_deterministic_imagenet,
    )
    mods = dict(det=main_deterministic_imagenet, moped=trainer,
                dnn2bnn=main_bayesian_imagenet_dnn2bnn,
                qbnn=main_bayesian_imagenet_bnn2qbnn)
    for mod in mods.values():
        monkeypatch.setattr(mod, "load_imagenet_val", _small_imagenet)
    return mods


def test_deterministic_then_moped_trainers(trainers, tmp_path):
    """The deterministic trainer trains and tests; ``--moped`` starts the
    Bayesian trainer from its checkpoint (before a ``--resume``, which
    then continues against the same priors)."""
    det_dir, bayes_dir = tmp_path / "det", tmp_path / "moped"
    acc = trainers["det"].main(COMMON + ["--epochs=1",
                                         f"--save_dir={det_dir}"])
    ckpt = det_dir / "imagenet_det_resnet18.pt"
    assert ckpt.is_file() and 0.0 <= acc <= 1.0
    assert trainers["det"].main(COMMON + ["--mode=test",
                                          f"--save_dir={det_dir}"]) == acc
    moped = ["--moped", f"--moped-ckpt={ckpt}", "--delta=0.1",
             "--num_monte_carlo=2", f"--save_dir={bayes_dir}"]
    metrics = trainers["moped"].main(COMMON + ["--epochs=1", *moped])
    assert 0.0 <= metrics["accuracy"] <= 1.0
    resumed = trainers["moped"].main(COMMON + ["--epochs=2", "--resume",
                                               *moped])
    tested = trainers["moped"].main(COMMON + ["--mode=test", *moped])
    assert set(tested) == set(resumed) == set(metrics)


def test_dnn2bnn_and_bnn2qbnn_trainers(trainers, tmp_path):
    d2b = tmp_path / "d2b"
    metrics = trainers["dnn2bnn"].main(COMMON + [
        "--epochs=1", "--num_mc=2", "--num_monte_carlo=2",
        f"--save_dir={d2b}"])
    assert 0.0 <= metrics["accuracy"] <= 1.0
    assert (d2b / "metrics.json").is_file()
    tested = trainers["dnn2bnn"].main(COMMON + [
        "--mode=test", "--num_monte_carlo=2", f"--save_dir={d2b}"])
    assert set(tested) == set(metrics)
    launches = kf.qmatmul_requant.launches
    out = trainers["qbnn"].main(COMMON + [
        "--calib-batch-size=16", "--fuse-conv-bn", "--quantize-activations",
        f"--bnn-ckpt={d2b / 'imagenet_dnn2bnn_resnet18.pt'}"])
    assert set(out) == {"float", "int8"}
    for m in out.values():
        assert 0.0 <= m["accuracy"] <= 1.0
    assert kf.qmatmul_requant.launches == launches  # CPU: plain version


def test_engine_train_resumes_and_evaluate_needs_a_full_batch(tmp_path):
    rs = np.random.RandomState(1)
    x = rs.randn(24, 3, 16, 16).astype(np.float32)
    y = rs.randint(0, 10, 24).astype(np.int32)

    def fresh():
        model = TorchTiny(torch.Generator().manual_seed(5)).train()
        return model, engine.make_optimizer(model, 0.01, kind="sgd")

    a, opt_a = fresh()
    hist = engine.train(a, opt_a, (x, y), epochs=2, batch_size=8,
                        num_mc=2, log_every=1,
                        checkpoint_dir=str(tmp_path / "a"))
    assert [h["epoch"] for h in hist] == [0, 1]
    b, opt_b = fresh()
    engine.train(b, opt_b, (x, y), epochs=1, batch_size=8, num_mc=2,
                 checkpoint_dir=str(tmp_path / "b"))
    b, opt_b = fresh()
    hist = engine.train(b, opt_b, (x, y), epochs=2, batch_size=8, num_mc=2,
                        checkpoint_dir=str(tmp_path / "b"), resume=True)
    assert [h["epoch"] for h in hist] == [1]
    for (name, va), vb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(va, vb), name
    assert isinstance(opt_b, torch.optim.SGD)
    assert isinstance(engine.make_optimizer(b, 0.01), torch.optim.Adam)

    a.eval()
    metrics = engine.evaluate(a, (x, y), batch_size=8, num_monte_carlo=3,
                              save_probs_to=str(tmp_path / "p.npy"))
    probs = np.load(tmp_path / "p.npy")
    assert probs.shape == (3, 24, 10)
    np.testing.assert_allclose(metrics["predictive_entropy"],
                               tutil.predictive_entropy(probs).mean(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="no full batch"):
        engine.evaluate(a, (x[:7], y[:7]), batch_size=8)


def test_training_checkpoint_restores_generators_and_refuses_others(
        tmp_path):
    model = TorchTiny(torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    save_training_checkpoint(tmp_path / "c.pt", model, opt, epoch=3,
                             best_acc=0.25)
    want = torch.randn(4, generator=model.conv1.generator)
    meta = load_training_checkpoint(tmp_path / "c.pt", model, opt)
    assert meta == {"epoch": 3, "best_acc": 0.25}
    torch.testing.assert_close(
        torch.randn(4, generator=model.conv1.generator), want, rtol=0,
        atol=0)
    other = torch.nn.Sequential(TorchTiny(torch.Generator()))
    with pytest.raises((RuntimeError, ValueError)):
        load_training_checkpoint(tmp_path / "c.pt", other)


# --- the MNIST and CIFAR slice: data, schedules, optimizer, trainers ------


def test_mnist_and_cifar_loaders_give_the_jax_arrays(tmp_path):
    """The synthetic sets under the same caps (tests/conftest.py shrinks
    them through BTT_SYNTH_TRAIN_N / BTT_SYNTH_TEST_N, read by both
    modules), and npz archives of bytes, scaled and normalised alike."""
    assert (tdata._SYNTH_TRAIN_CAP, tdata._SYNTH_TEST_CAP) == (
        jdata._SYNTH_TRAIN_CAP, jdata._SYNTH_TEST_CAP)
    rs = np.random.RandomState(2)
    for name, shape in (("mnist.npz", (28, 28)),
                        ("cifar10.npz", (32, 32, 3))):
        np.savez(tmp_path / name,
                 x_train=rs.randint(0, 256, (6,) + shape).astype(np.uint8),
                 y_train=rs.randint(0, 10, 6),
                 x_test=rs.randint(0, 256, (4,) + shape).astype(np.uint8),
                 y_test=rs.randint(0, 10, 4))
    for loader in ("load_mnist", "load_cifar10"):
        for kw in (dict(synthetic=True), dict(data_dir=str(tmp_path)),
                   dict(data_dir=str(tmp_path), synthetic=True),
                   dict(synthetic=True, n_train=40, n_test=9)):
            got = getattr(tdata, loader)(**kw)
            want = getattr(jdata, loader)(**kw)
            for (xa, ya), (xb, yb) in zip(got, want):
                assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)
    (x_tr, _), (x_te, _) = tdata.load_cifar10(synthetic=True)
    assert x_tr.shape == (tdata._SYNTH_TRAIN_CAP, 3, 32, 32)
    assert x_te.shape == (tdata._SYNTH_TEST_CAP, 3, 32, 32)
    np.testing.assert_array_equal(
        tdata.load_imagenet_val(synthetic=True, n=5000, img=4)[0],
        jdata.load_imagenet_val(synthetic=True, n=5000, img=4)[0])


def test_schedules_count_optimizer_steps_as_optax():
    """The CIFAR trainers' schedules by optimizer step against optax, and
    a ``step_scheduler`` stepped once per optimizer step sets the
    learning rate of step k to schedule(k). At 200 epochs the piecewise
    schedule falls after step 100 and step 150 (not epochs: ROADMAP F6)."""
    import optax

    from bayesian_torch_tpu.examples import main_bayesian_cifar as jcifar
    from bayesian_torch_tpu_torch.examples import main_bayesian_cifar as tc

    for epochs in (200, 7, 1):
        got, want = tc.lr_schedule(1e-3, epochs), jcifar.lr_schedule(1e-3,
                                                                      epochs)
        for k in range(0, 2 * epochs + 3):
            assert got(k) == pytest.approx(float(want(k)), rel=1e-6), k
    assert tc.lr_schedule(1e-3, 200)(99) == pytest.approx(1e-3)
    assert tc.lr_schedule(1e-3, 200)(100) == pytest.approx(1e-4)
    assert tc.lr_schedule(1e-3, 200)(150) == pytest.approx(1e-5)
    got = engine.cosine_decay_schedule(0.1, 400)
    want = optax.cosine_decay_schedule(0.1, 400)
    for k in range(0, 450, 7):
        # optax evaluates in f32: near the end 0.5 * (1 + cos) cancels to a
        # few f32 ulps of 1, each 0.1 * 2^-24 = 6e-9 of the rate
        assert got(k) == pytest.approx(float(want(k)), rel=1e-5, abs=2e-8)
    param = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.SGD([param], lr=got(0), momentum=0.9)
    sched = engine.step_scheduler(opt, got)
    for k in range(12):
        assert opt.param_groups[0]["lr"] == pytest.approx(got(k), rel=1e-12)
        opt.step()
        sched.step()
    with pytest.raises(ValueError, match="schedule"):
        engine.step_scheduler(torch.optim.SGD([param], lr=1.0), got)


def test_adadelta_steps_match_optax():
    """``make_optimizer(kind="adadelta")`` (the MNIST trainers') against
    ``optax.adadelta(1.0)`` on the same gradients, three steps."""
    import optax

    rs = np.random.RandomState(3)
    p0 = rs.randn(5, 4).astype(np.float32)
    grads = [rs.randn(5, 4).astype(np.float32) for _ in range(3)]
    layer = torch.nn.Linear(4, 5, bias=False)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(p0))
    opt = engine.make_optimizer(layer, 1.0, kind="adadelta")
    assert isinstance(opt, torch.optim.Adadelta)
    tx = optax.adadelta(1.0)
    p, state = p0, tx.init(p0)
    for g in grads:
        layer.weight.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   np.asarray(p), rtol=1e-5, atol=1e-6)


class _FakeWriter:
    """A stand-in for ``SummaryWriter`` (importing tensorboard takes
    seconds) that keeps the scalars."""

    def __init__(self, log_dir):
        self.log_dir, self.scalars = log_dir, []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))


def _fake_tensorboard(monkeypatch):
    import sys
    import types
    writers = []

    def make(log_dir):
        writers.append(_FakeWriter(log_dir))
        return writers[-1]

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=make))
    return writers


def test_make_writer_logs_or_returns_none(tmp_path, monkeypatch, capsys):
    import sys
    writers = _fake_tensorboard(monkeypatch)
    assert engine.make_writer(str(tmp_path / "tb")) is writers[0]
    assert writers[0].log_dir == str(tmp_path / "tb")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert engine.make_writer(str(tmp_path / "tb2")) is None
    assert "tensorboard unavailable" in capsys.readouterr().out


def _small_mnist(data_dir=None, synthetic=False):
    return (tdata._synthetic(32, (1, 28, 28), 10, 0, proto_seed=100),
            tdata._synthetic(16, (1, 28, 28), 10, 1, proto_seed=100))


def _small_cifar(data_dir=None, synthetic=False):
    return (tdata._synthetic(32, (3, 32, 32), 10, 2, proto_seed=200),
            tdata._synthetic(16, (3, 32, 32), 10, 3, proto_seed=200))


SMALL = ["--synthetic", "--device=cpu", "--batch-size=16",
         "--test-batch-size=16"]


@pytest.fixture
def small_trainers(monkeypatch):
    from bayesian_torch_tpu_torch.examples import (
        main_bayesian_cifar,
        main_bayesian_cifar_dnn2bnn,
        main_bayesian_flipout_cifar,
        main_bayesian_mnist,
        main_deterministic_cifar,
        main_deterministic_mnist,
        quantization_test,
    )
    mods = dict(det_mnist=main_deterministic_mnist,
                mnist=main_bayesian_mnist, det_cifar=main_deterministic_cifar,
                cifar=main_bayesian_cifar,
                flipout_cifar=main_bayesian_flipout_cifar,
                dnn2bnn=main_bayesian_cifar_dnn2bnn,
                quantization_test=quantization_test)
    for mod in mods.values():
        for name, small in (("load_mnist", _small_mnist),
                            ("load_cifar10", _small_cifar)):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, small)
    return mods


def test_small_model_trainers_default_to_cuda(small_trainers):
    from bayesian_torch_tpu_torch.examples import main_deterministic_imagenet

    for name, mod in small_trainers.items():
        if name == "quantization_test":
            continue
        if hasattr(mod, "build_parser"):
            assert mod.build_parser().parse_args([]).device == "cuda", name
    assert main_deterministic_imagenet.evaluate_det is \
        small_trainers["det_mnist"].evaluate_det
    with pytest.raises(NotImplementedError, match="#15"):
        small_trainers["cifar"].main(SMALL + ["--mesh-mc=2"])
    with pytest.raises(NotImplementedError, match="#15"):
        small_trainers["mnist"].main(SMALL + ["--mesh-mc=2"])


def test_mnist_trainers_end_to_end(small_trainers, tmp_path, monkeypatch):
    """The deterministic SCNN trains and tests; the Bayesian SCNN trains
    through the vmap emission (--num_mc 2), logs its scalars with
    --tensorboard, resumes, and tests with its MC probabilities dumped."""
    writers = _fake_tensorboard(monkeypatch)
    det, bayes = small_trainers["det_mnist"], small_trainers["mnist"]
    det_dir, bayes_dir = tmp_path / "det", tmp_path / "bayes"
    acc = det.main(SMALL + ["--epochs=1", f"--save_dir={det_dir}"])
    assert (det_dir / "mnist_det_scnn.pt").is_file() and 0.0 <= acc <= 1.0
    assert det.main(SMALL + ["--mode=test", f"--save_dir={det_dir}"]) == acc
    args = SMALL + ["--num_monte_carlo=3", "--num_mc=2",
                    f"--save_dir={bayes_dir}"]
    metrics = bayes.main(args + ["--epochs=1", "--tensorboard"])
    assert 0.0 <= metrics["accuracy"] <= 1.0
    assert writers[0].log_dir == str(bayes_dir / "tb")
    assert ("train/elbo_loss", 0) in writers[0].scalars
    assert ("val/accuracy", 1) in writers[0].scalars
    assert (bayes_dir / "mnist_metrics.json").is_file()
    assert torch.load(bayes_dir / "last.pt", weights_only=True)["meta"][
        "epoch"] == 1
    resumed = bayes.main(args + ["--epochs=2", "--resume"])
    assert set(resumed) == set(metrics)
    bayes.main(args + ["--mode=test"])
    assert np.load(bayes_dir / "probs_mnist_mc.npy").shape == (3, 16, 10)


def test_cifar_trainers_end_to_end(small_trainers, tmp_path):
    """The deterministic ResNet-20 trains and tests; the Bayesian one
    starts from its checkpoint with --moped, keeps the scheduler's step
    count in last.pt and resumes from it; the Flipout trainer trains
    through the vmap emission and tests."""
    det_dir, bayes_dir = tmp_path / "det", tmp_path / "bayes"
    flip_dir = tmp_path / "flipout"
    acc = small_trainers["det_cifar"].main(SMALL + [
        "--epochs=1", f"--save_dir={det_dir}"])
    ckpt = det_dir / "cifar_det_resnet20.pt"
    assert ckpt.is_file() and 0.0 <= acc <= 1.0
    assert small_trainers["det_cifar"].main(SMALL + [
        "--mode=test", f"--save_dir={det_dir}"]) == acc
    args = SMALL + ["--moped", f"--moped-ckpt={ckpt}", "--delta=0.1",
                    "--num_monte_carlo=2", f"--save_dir={bayes_dir}"]
    metrics = small_trainers["cifar"].main(args + ["--epochs=1"])
    assert 0.0 <= metrics["accuracy"] <= 1.0
    last = torch.load(bayes_dir / "last.pt", weights_only=True)
    assert last["sched"]["last_epoch"] == 2  # 32 images, 2 steps
    resumed = small_trainers["cifar"].main(args + ["--epochs=2",
                                                   "--resume"])
    assert torch.load(bayes_dir / "last.pt", weights_only=True)["sched"][
        "last_epoch"] == 4
    tested = small_trainers["cifar"].main(args + ["--mode=test"])
    assert set(tested) == set(resumed) == set(metrics)
    assert (bayes_dir / "probs_cifar_bayesian_mc.npy").is_file()
    flip = small_trainers["flipout_cifar"].main(SMALL + [
        "--epochs=1", "--num_mc=2", "--num_monte_carlo=2",
        f"--save_dir={flip_dir}"])
    assert 0.0 <= flip["accuracy"] <= 1.0
    assert (flip_dir / "cifar_flipout_resnet20.pt").is_file()


def test_cifar_dnn2bnn_ptq_and_quantization_test(small_trainers, tmp_path):
    """dnn_to_bnn of the deterministic ResNet-20: train, test, then PTQ
    (prepare, calibrate on about 100 images, convert, INT8 evaluation)
    through K-F's plain version on the CPU; then the SCNN round trip."""
    d2b = tmp_path / "d2b"
    mod = small_trainers["dnn2bnn"]
    args = SMALL + ["--num_monte_carlo=2", f"--save_dir={d2b}"]
    metrics = mod.main(args + ["--epochs=1", "--num_mc=2"])
    assert 0.0 <= metrics["accuracy"] <= 1.0
    assert (d2b / "metrics.json").is_file()
    assert set(mod.main(args + ["--mode=test"])) == set(metrics)
    launches = kf.qmatmul_requant.launches
    out = mod.main(args + ["--mode=ptq"])
    assert set(out) == {"float", "int8"}
    for m in out.values():
        assert 0.0 <= m["accuracy"] <= 1.0
    log_probs, kl = small_trainers["quantization_test"].main(
        ["--device=cpu"])
    assert log_probs.shape == (1, 10) and float(kl) == 0.0
    torch.testing.assert_close(log_probs.exp().sum(), torch.tensor(1.0))
    assert kf.qmatmul_requant.launches == launches  # CPU: plain version


# --- the LSTM time-series trainer ------------------------------------------

LSTM_SMALL = ["--device=cpu", "--seq-len=8", "--hidden=8", "--batch-size=4",
              "--steps=3", "--num_monte_carlo=3"]
ESTIMATORS = ("Reparameterization", "Flipout")


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_lstm_trainer_trains_then_tests_from_its_checkpoint(
        estimator, tmp_path, monkeypatch, capsys):
    from bayesian_torch_tpu_torch.examples import (
        main_bayesian_lstm_timeseries as lstm_trainer,
    )

    assert lstm_trainer.build_parser().parse_args([]).device == "cuda"
    args = LSTM_SMALL + [f"--estimator={estimator}",
                         f"--save_dir={tmp_path}"]
    rmse = lstm_trainer.main(args)
    out = capsys.readouterr().out
    assert "step 0: nll+kl" in out and "step 2: nll+kl" in out
    assert "2-sigma coverage" in out and np.isfinite(rmse)
    saved = torch.load(tmp_path / f"lstm_{estimator.lower()}.pt",
                       weights_only=True)
    assert {"lstm.ih.mu_weight", "lstm.hh.rho_bias",
            "head.mu_weight"} <= set(saved)
    loaded = {}
    real_load = lstm_trainer.load_checkpoint

    def load(model, path):
        real_load(model, path)
        loaded.update(model.state_dict())
    monkeypatch.setattr(lstm_trainer, "load_checkpoint", load)
    assert np.isfinite(lstm_trainer.main(args + ["--mode=test"]))
    assert "test RMSE" in capsys.readouterr().out
    assert set(loaded) == set(saved)
    for key, value in saved.items():
        torch.testing.assert_close(loaded[key], value, rtol=0, atol=0)


def test_lstm_series_and_windows_equal_jax():
    from bayesian_torch_tpu.examples import (
        main_bayesian_lstm_timeseries as jt,
    )
    from bayesian_torch_tpu_torch.examples import (
        main_bayesian_lstm_timeseries as tt,
    )

    for n, seed in ((20000, 0), (777, 3)):
        got, want = tt.make_series(n, seed), jt.make_series(n, seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    series = tt.make_series()
    for seq_len, batch in ((64, 128), (8, 4)):
        got = tt.windows(series, seq_len, batch, np.random.RandomState(5))
        want = jt.windows(series, seq_len, batch, np.random.RandomState(5))
        for a, b in zip(got, want):
            assert a.shape == (batch, seq_len, 1)
            np.testing.assert_array_equal(a, b)


def _lstm_regressor_twins(estimator, rho=None, hidden=8):
    from bayesian_torch_tpu.examples import (
        main_bayesian_lstm_timeseries as jt,
    )
    from bayesian_torch_tpu.layers.base_variational_layer import make_rngs
    from bayesian_torch_tpu.utils.checkpoint import import_torch_state_dict
    from bayesian_torch_tpu_torch.examples import (
        main_bayesian_lstm_timeseries as tt,
    )
    from bayesian_torch_tpu_torch.utils.checkpoint import load_jax_state
    from tests._torch_port import jax_arrays, random_state

    jm = jt.BayesianLSTMRegressor(hidden, estimator,
                                  make_rngs(1, noise_seed=2))
    arrays = random_state(jax_arrays(jm), seed=2, rho=rho)
    import_torch_state_dict(jm, arrays)
    tm = tt.BayesianLSTMRegressor(hidden, estimator,
                                  generator=torch.Generator().manual_seed(1),
                                  device="cpu")
    load_jax_state(tm, arrays)
    return jt, tt, jm, tm


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_lstm_regressor_and_nll_equal_jax(estimator, monkeypatch):
    """The port's regressor and ``gaussian_nll`` equal JAX's at the same
    weights and noise: the LSTM's from ``lstm_jax_noise``, the head's from
    the next key of the shared rngs (the LSTM draws its base key first)."""
    import functools

    import jax
    import jax.numpy as jnp
    from flax import nnx

    from bayesian_torch_tpu.ops.sampling import rademacher_fused
    from tests._torch_port import lstm_jax_noise

    jt, tt, jm, tm = _lstm_regressor_twins(estimator)
    x, y = tt.windows(tt.make_series(2000), 8, 4, np.random.RandomState(0))
    rngs = nnx.clone(jm.lstm.rngs)
    rngs.noise()
    head_key = rngs.noise()
    if estimator == "Flipout":
        k_eps, k_epsb, k_sin, k_sout = jax.random.split(head_key, 4)
        head_noise = dict(eps_w=jax.random.normal(k_eps, (2, 8)),
                          eps_b=jax.random.normal(k_epsb, (2,)),
                          sign_in=rademacher_fused(k_sin, (4, 8, 8)),
                          sign_out=rademacher_fused(k_sout, (4, 8, 2)))
    else:
        kw, kb = jax.random.split(head_key)
        head_noise = dict(eps_w=jax.random.normal(kw, (2, 8)),
                          eps_b=jax.random.normal(kb, (2,)))

    def torch_of(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    lstm_noise = {k: tuple(map(torch_of, pair))
                  for k, pair in lstm_jax_noise(jm.lstm, 8, 4).items()}
    monkeypatch.setattr(tm.lstm, "forward",
                        functools.partial(tm.lstm.forward, **lstm_noise))
    monkeypatch.setattr(tm.head, "forward", functools.partial(
        tm.head.forward, **{k: torch_of(v) for k, v in head_noise.items()}))
    want, want_kl = jm(jnp.asarray(x))
    got, got_kl = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)
    assert got_kl.item() == pytest.approx(float(want_kl), rel=1e-5)
    nll = tt.gaussian_nll(got, torch.from_numpy(y)).item()
    assert nll == pytest.approx(float(jt.gaussian_nll(want, jnp.asarray(y))),
                                rel=1e-5)


def test_lstm_adam_step_matches_optax():
    """At rho = -30 (the noise vanishes) one trainer step of the port
    (``train_step``: NLL + KL / batch, ``torch.optim.Adam``) gives the loss
    and the updated parameters of JAX's step with ``optax.adam``."""
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from tests._torch_port import jax_arrays

    jt, tt, jm, tm = _lstm_regressor_twins("Reparameterization", rho=-30.0)
    x, y = tt.windows(tt.make_series(2000), 8, 4, np.random.RandomState(1))

    def loss_fn(model):
        pred, kl = model(jnp.asarray(x))
        return jt.gaussian_nll(pred, jnp.asarray(y)) + kl / x.shape[0]

    optimizer = nnx.Optimizer(jm, optax.adam(3e-3), wrt=nnx.Param)
    want_loss, grads = nnx.value_and_grad(loss_fn)(jm)
    optimizer.update(jm, grads)
    loss = tt.train_step(tm, torch.optim.Adam(tm.parameters(), lr=3e-3),
                         torch.from_numpy(x), torch.from_numpy(y))
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want = jax_arrays(jm)
    for key, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key], atol=2e-6,
                                   rtol=0, err_msg=key)
