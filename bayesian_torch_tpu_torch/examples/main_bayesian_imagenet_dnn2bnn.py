"""Bayesian ResNet on ImageNet by converting a deterministic one with
``dnn_to_bnn``, the port's trainer (counterpart of
``bayesian_torch_tpu/examples/main_bayesian_imagenet_dnn2bnn.py``).

    python -m bayesian_torch_tpu_torch.examples.main_bayesian_imagenet_dnn2bnn \\
        --synthetic --mode=train --epochs=2 --batch-size=32

The deterministic zoo model (its weights from ``--det-ckpt``, a
``main_deterministic_imagenet`` checkpoint, if given) is converted in
place with the reference's ``const_bnn_prior_parameters`` (``--bnn-type``,
``--moped_enable``, ``--moped_delta``). Each step's loss is the
cross-entropy of the mean over ``--num_mc`` draws of the logits
(``mc_forward(..., return_kl=False)``: the converted layers return bare
outputs) plus ``get_kl_loss / batch_size``; SGD with momentum 0.9, f32.
After training the model is evaluated (``_engine.evaluate``, MC
predictive) on a fifth of the data and saved to
``<save_dir>/imagenet_dnn2bnn_<arch>.pt``, the metrics to
``<save_dir>/metrics.json``. ``--mode=test`` loads and evaluates.
``--device`` (default ``cuda``) names where the model runs.
"""

from __future__ import annotations

import argparse
import os

import torch

from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples._data import load_imagenet_val
from bayesian_torch_tpu_torch.models import dnn_to_bnn
from bayesian_torch_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)


def build_parser():
    p = argparse.ArgumentParser(description="ImageNet dnn_to_bnn")
    p.add_argument("--arch", type=str, default="resnet50",
                   choices=["resnet18", "resnet34", "resnet50",
                            "resnet101", "resnet152"])
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test"])
    p.add_argument("--num_monte_carlo", type=int, default=10)
    p.add_argument("--num_mc", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--save_dir", type=str,
                   default="./checkpoint/imagenet_dnn2bnn")
    p.add_argument("--bnn-type", type=str, default="Reparameterization",
                   choices=["Reparameterization", "Flipout"])
    p.add_argument("--moped_enable", action="store_true")
    p.add_argument("--moped_delta", type=float, default=0.5)
    p.add_argument("--det-ckpt", type=str, default=None)
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    x, y = load_imagenet_val(args.data_dir, args.synthetic,
                             num_classes=args.num_classes)
    n_val = max(1, len(x) // 5)
    train_data, test_data = (x[n_val:], y[n_val:]), (x[:n_val], y[:n_val])

    from bayesian_torch_tpu_torch.models.deterministic import (
        resnet_large as det_zoo)
    device = torch.device(args.device)
    model = getattr(det_zoo, args.arch)(
        num_classes=args.num_classes,
        generator=torch.Generator().manual_seed(args.seed), device=device)
    if args.det_ckpt:
        load_checkpoint(model, args.det_ckpt)

    const_bnn_prior_parameters = {
        "prior_mu": 0.0,
        "prior_sigma": 1.0,
        "posterior_mu_init": 0.0,
        "posterior_rho_init": -3.0,
        "type": args.bnn_type,
        "moped_enable": args.moped_enable,
        "moped_delta": args.moped_delta,
    }
    dnn_to_bnn(model, const_bnn_prior_parameters)
    ckpt_path = os.path.join(args.save_dir,
                             f"imagenet_dnn2bnn_{args.arch}.pt")

    if args.mode == "test":
        load_checkpoint(model, ckpt_path)
        model.eval()
        return engine.evaluate(model, test_data, batch_size=args.batch_size,
                               num_monte_carlo=args.num_monte_carlo)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    engine.train_dnn2bnn(model, optimizer, train_data, epochs=args.epochs,
                         batch_size=args.batch_size, num_mc=args.num_mc,
                         log_every=10)
    model.eval()
    metrics = engine.evaluate(model, test_data, batch_size=args.batch_size,
                              num_monte_carlo=args.num_monte_carlo)
    save_checkpoint(model, ckpt_path)
    engine.save_metrics(metrics, os.path.join(args.save_dir, "metrics.json"))
    return metrics


if __name__ == "__main__":
    main()
