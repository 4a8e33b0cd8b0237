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
  resnet18 at 32x32: train, then test (INT8: float eval, then INT8 eval).
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
    for flag, item in (("--mesh-mc=2", "#15"), ("--structured-mc", "#16"),
                       ("--remat", "#9")):
        with pytest.raises(NotImplementedError, match=item):
            trainer.main(["--synthetic", "--device=cpu", flag])


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
