"""Bayesian SCNN on MNIST (reparameterization), the port's trainer
(counterpart of ``bayesian_torch_tpu/examples/main_bayesian_mnist.py``).

    python -m bayesian_torch_tpu_torch.examples.main_bayesian_mnist \\
        --synthetic --epochs=1

Each step is the engine's ELBO (``_engine.make_train_step``: the NLL of
the mean over ``--num_mc`` draws of the per-draw log_softmax, plus KL /
batch size) with Adadelta(``--lr``), as the reference's
``main_bayesian_mnist`` trains; ``--num_mc`` above 1 runs the vmap
emission. ``<save_dir>/last.pt`` holds the ``--resume`` checkpoint after
every epoch; after training the model takes an MC-``--num_monte_carlo``
evaluation of the test split and is saved to
``<save_dir>/mnist_bayesian_scnn.pt``, the metrics to
``<save_dir>/mnist_metrics.json``. ``--mode=test`` loads the model,
evaluates it and dumps the MC probabilities to
``<save_dir>/probs_mnist_mc.npy``. ``--tensorboard`` logs scalars to
``<save_dir>/tb``. ``--device`` (default ``cuda``) names where the model
runs. Under ``torchrun --nproc-per-node N`` the trainer spans the N ranks:
``--mesh-mc`` of them carry the draws, the rest the batch
(``_engine.mesh_for``), and only the first rank writes.
"""

from __future__ import annotations

import argparse
import os

import torch

from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples._data import load_mnist
from bayesian_torch_tpu_torch.models.bayesian.simple_cnn_variational import (
    SCNN,
)
from bayesian_torch_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)


def build_parser():
    p = argparse.ArgumentParser(description="Bayesian SCNN MNIST")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--test-batch-size", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=14)
    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test"])
    p.add_argument("--num_monte_carlo", type=int, default=20,
                   help="MC samples at test time")
    p.add_argument("--num_mc", type=int, default=1,
                   help="MC samples during training")
    p.add_argument("--save_dir", type=str, default="./checkpoint/bayesian")
    p.add_argument("--resume", action="store_true",
                   help="resume from <save_dir>/last.pt (epoch, optimizer, "
                        "generator states)")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic data (no-network environments)")
    p.add_argument("--tensorboard", action="store_true",
                   help="log scalars to <save_dir>/tb")
    p.add_argument("--mesh-mc", type=int, default=1,
                   help="mesh slots for the MC axis (rest go to data)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = engine.mesh_for(args)
    train_data, test_data = load_mnist(args.data_dir, args.synthetic)

    model = engine.place(
        SCNN(generator=torch.Generator().manual_seed(args.seed),
             device=engine.rank_device(args.device, mesh)), mesh)
    ckpt_path = os.path.join(args.save_dir, "mnist_bayesian_scnn.pt")

    if args.mode == "test":
        load_checkpoint(model, ckpt_path)
        model.eval()
        return engine.evaluate(
            model, test_data, batch_size=args.test_batch_size,
            num_monte_carlo=args.num_monte_carlo, mesh=mesh,
            save_probs_to=os.path.join(args.save_dir, "probs_mnist_mc.npy"))
    model.train()
    writer = (engine.make_writer(os.path.join(args.save_dir, "tb"))
              if args.tensorboard and engine.is_writer(mesh) else None)
    # the reference trains with Adadelta(lr=1.0)
    optimizer = engine.make_optimizer(model, args.lr, kind="adadelta")
    engine.train(model, optimizer, train_data, epochs=args.epochs,
                 batch_size=args.batch_size, num_mc=args.num_mc,
                 writer=writer, mesh=mesh, checkpoint_dir=args.save_dir,
                 resume=args.resume)
    model.eval()
    metrics = engine.evaluate(model, test_data,
                              batch_size=args.test_batch_size,
                              num_monte_carlo=args.num_monte_carlo,
                              writer=writer, epoch=args.epochs, mesh=mesh)
    if engine.is_writer(mesh):
        save_checkpoint(model, ckpt_path)
        engine.save_metrics(metrics, os.path.join(args.save_dir,
                                                  "mnist_metrics.json"))
    return metrics


if __name__ == "__main__":
    main()
