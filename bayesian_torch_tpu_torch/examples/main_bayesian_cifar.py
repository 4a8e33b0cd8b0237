"""Bayesian CIFAR ResNet (reparameterization; the Flipout trainer
``main_bayesian_flipout_cifar`` shares ``run``), the port's trainer
(counterpart of ``bayesian_torch_tpu/examples/main_bayesian_cifar.py``).

    python -m bayesian_torch_tpu_torch.examples.main_bayesian_cifar \\
        --synthetic --epochs=1 --arch=resnet20

Each step is the engine's ELBO (``_engine.make_train_step``) through
``mc_forward`` in training mode (``--num_mc`` above 1 runs the vmap
emission), with Adam under ``lr_schedule``, f32. The schedule is the JAX
trainer's optax ``piecewise_constant_schedule``, whose boundaries
(``epochs * 0.5`` and ``epochs * 0.75``, each a factor 0.1) count
optimizer steps, not epochs: the port follows the JAX package, stepping a
``LambdaLR`` once per optimizer step (the reference steps its schedule per
epoch; ROADMAP F6). ``<save_dir>/last.pt`` holds the ``--resume``
checkpoint after every epoch, the scheduler's step count included. After
training the model takes an MC-``--num_monte_carlo`` evaluation (default
50) at ``--test-batch-size`` and is saved to
``<save_dir>/cifar_<tag>_<arch>.pt``, the metrics to
``<save_dir>/cifar_<tag>_metrics.json`` (tag ``bayesian`` or ``flipout``);
``--mode=test`` loads, evaluates and dumps the MC probabilities to
``<save_dir>/probs_cifar_<tag>_mc.npy``. ``--moped`` initialises the model
from a deterministic ResNet of the same depth (``utils.MOPED`` with
``--delta``): one built from seed ``--seed + 7``, or loaded from
``--moped-ckpt`` (a ``main_deterministic_cifar`` checkpoint). ``--device``
(default ``cuda``) names where the model runs. ``--structured-mc``
evaluates through ``mc_forward(structured=True)``; ``--mesh-mc`` above 1
is refused (``_engine.UNPORTED``).
"""

from __future__ import annotations

import argparse
import os

import torch

from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples._data import load_cifar10
from bayesian_torch_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
from bayesian_torch_tpu_torch.utils.util import MOPED


def build_parser(desc="Bayesian CIFAR10"):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--arch", type=str, default="resnet20",
                   choices=["resnet20", "resnet32", "resnet44", "resnet56",
                            "resnet110"])
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--test-batch-size", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test"])
    p.add_argument("--num_monte_carlo", type=int, default=50)
    p.add_argument("--structured-mc", action="store_true",
                   help="evaluate through mc_forward(structured=True): the "
                        "draws as channel blocks of one forward")
    p.add_argument("--num_mc", type=int, default=1)
    p.add_argument("--save_dir", type=str, default="./checkpoint/bayesian")
    p.add_argument("--resume", action="store_true",
                   help="resume from <save_dir>/last.pt (epoch, optimizer, "
                        "scheduler, generator states)")
    p.add_argument("--moped", action="store_true",
                   help="initialize posteriors from a deterministic ckpt")
    p.add_argument("--moped-ckpt", type=str, default=None)
    p.add_argument("--delta", type=float, default=0.2)
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--mesh-mc", type=int, default=1,
                   help="values above 1 are not ported (refused)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    return p


def lr_schedule(base_lr, epochs):
    """The JAX trainer's staged decay: a factor 0.1 from optimizer step
    ``int(epochs * 0.5)`` and another from step ``int(epochs * 0.75)``."""
    return engine.piecewise_constant_schedule(
        base_lr, {int(epochs * 0.5): 0.1, int(epochs * 0.75): 0.1})


def get_model(arch, seed, estimator="Reparameterization", device=None):
    if estimator == "Flipout":
        from bayesian_torch_tpu_torch.models.bayesian import (
            resnet_flipout as zoo)
    else:
        from bayesian_torch_tpu_torch.models.bayesian import (
            resnet_variational as zoo)
    return getattr(zoo, arch)(generator=torch.Generator().manual_seed(seed),
                              device=device)


def run(args, estimator="Reparameterization"):
    engine.refuse_unported(args)
    train_data, test_data = load_cifar10(args.data_dir, args.synthetic)
    device = torch.device(args.device)
    model = get_model(args.arch, args.seed, estimator, device)
    tag = "flipout" if estimator == "Flipout" else "bayesian"
    ckpt_path = os.path.join(args.save_dir, f"cifar_{tag}_{args.arch}.pt")
    if args.moped:
        from bayesian_torch_tpu_torch.models.deterministic import (
            resnet as det_zoo)
        det = getattr(det_zoo, args.arch)(
            generator=torch.Generator().manual_seed(args.seed + 7),
            device=device)
        MOPED(model, det, args.moped_ckpt, args.delta)
        print(f"applied MOPED init (delta={args.delta})")

    if args.mode == "test":
        load_checkpoint(model, ckpt_path)
        model.eval()
        return engine.evaluate(
            model, test_data, batch_size=args.test_batch_size,
            num_monte_carlo=args.num_monte_carlo,
            structured=args.structured_mc,
            save_probs_to=os.path.join(args.save_dir,
                                       f"probs_cifar_{tag}_mc.npy"))
    model.train()
    schedule = lr_schedule(args.lr, args.epochs)
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0))
    engine.train(model, optimizer, train_data, epochs=args.epochs,
                 batch_size=args.batch_size, num_mc=args.num_mc,
                 checkpoint_dir=args.save_dir, resume=args.resume,
                 scheduler=engine.step_scheduler(optimizer, schedule))
    model.eval()
    metrics = engine.evaluate(model, test_data,
                              batch_size=args.test_batch_size,
                              num_monte_carlo=args.num_monte_carlo,
                              structured=args.structured_mc)
    save_checkpoint(model, ckpt_path)
    engine.save_metrics(metrics, os.path.join(
        args.save_dir, f"cifar_{tag}_metrics.json"))
    return metrics


def main(argv=None):
    return run(build_parser().parse_args(argv), "Reparameterization")


if __name__ == "__main__":
    main()
