"""Bayesian CIFAR ResNet by converting a deterministic one with
``dnn_to_bnn``, and its INT8 post-training quantization, the port's
trainer (counterpart of
``bayesian_torch_tpu/examples/main_bayesian_cifar_dnn2bnn.py``).

    python -m bayesian_torch_tpu_torch.examples.main_bayesian_cifar_dnn2bnn \\
        --synthetic --mode=train --epochs=1
    python -m bayesian_torch_tpu_torch.examples.main_bayesian_cifar_dnn2bnn \\
        --synthetic --mode=ptq

The deterministic CIFAR ResNet (its weights from ``--det-ckpt``, a
``main_deterministic_cifar`` checkpoint, if given) is converted in place
with the reference's ``const_bnn_prior_parameters`` (``--bnn-type``,
``--moped_enable``, ``--moped_delta``). ``--mode=train``: each step's loss
is the cross-entropy of the mean over ``--num_mc`` draws of the logits
plus ``get_kl_loss / batch_size``, Adam(``--lr``), f32; then an
MC-``--num_monte_carlo`` evaluation, the model saved to
``<save_dir>/cifar_dnn2bnn_<arch>.pt`` and the metrics to
``<save_dir>/metrics.json``. ``--mode=test`` loads and evaluates.
``--mode=ptq`` loads the saved model if there is one, evaluates it in
float, then ``prepare``s it, calibrates it on the first 100 or so
training images (whole batches of ``--batch-size``), ``convert``s it to
INT8 (the convs and the head through the fused int8 GEMM, float
activations between layers) and evaluates it again; it returns
``{"float": metrics, "int8": metrics}``. ``--device`` (default ``cuda``)
names where the model runs.
"""

from __future__ import annotations

import argparse
import os

import torch

from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples._data import load_cifar10
from bayesian_torch_tpu_torch.models import dnn_to_bnn
from bayesian_torch_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)


def build_parser():
    p = argparse.ArgumentParser(description="CIFAR10 dnn_to_bnn")
    p.add_argument("--arch", type=str, default="resnet20",
                   choices=["resnet20", "resnet32", "resnet44", "resnet56",
                            "resnet110"])
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--test-batch-size", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test", "ptq"])
    p.add_argument("--num_monte_carlo", type=int, default=20)
    p.add_argument("--num_mc", type=int, default=1)
    p.add_argument("--save_dir", type=str, default="./checkpoint/dnn2bnn")
    p.add_argument("--bnn-type", type=str, default="Reparameterization",
                   choices=["Reparameterization", "Flipout"])
    p.add_argument("--moped_enable", action="store_true")
    p.add_argument("--moped_delta", type=float, default=0.5)
    p.add_argument("--det-ckpt", type=str, default=None,
                   help="deterministic warm-start checkpoint")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    return p


def build_bnn(args):
    """The deterministic ResNet of ``--arch`` (from ``--det-ckpt`` if
    given), converted in place by ``dnn_to_bnn``."""
    from bayesian_torch_tpu_torch.models.deterministic import (
        resnet as det_zoo)
    model = getattr(det_zoo, args.arch)(
        generator=torch.Generator().manual_seed(args.seed),
        device=torch.device(args.device))
    if args.det_ckpt:
        load_checkpoint(model, args.det_ckpt)
    # the reference's structured-config contract
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
    return model


def quantize(model, calib_data, batch_size=128, num_calib=100):
    """prepare -> calibrate on whole batches until ``num_calib`` images
    have passed -> convert, in place; returns the model."""
    from bayesian_torch_tpu_torch.quantization import convert

    engine.calibrate(model, calib_data, batch_size, num_calib)
    convert(model)
    return model


def main(argv=None):
    args = build_parser().parse_args(argv)
    train_data, test_data = load_cifar10(args.data_dir, args.synthetic)
    model = build_bnn(args)
    ckpt_path = os.path.join(args.save_dir, f"cifar_dnn2bnn_{args.arch}.pt")

    def evaluate():
        model.eval()
        return engine.evaluate(model, test_data,
                               batch_size=args.test_batch_size,
                               num_monte_carlo=args.num_monte_carlo)

    if args.mode == "test":
        load_checkpoint(model, ckpt_path)
        return evaluate()
    if args.mode == "ptq":
        if os.path.exists(ckpt_path):
            load_checkpoint(model, ckpt_path)
        print("float eval:")
        float_metrics = evaluate()
        quantize(model, train_data, args.batch_size)
        print("int8 eval:")
        return {"float": float_metrics, "int8": evaluate()}
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    engine.train_dnn2bnn(model, optimizer, train_data, epochs=args.epochs,
                         batch_size=args.batch_size, num_mc=args.num_mc,
                         log_every=50)
    metrics = evaluate()
    save_checkpoint(model, ckpt_path)
    engine.save_metrics(metrics, os.path.join(args.save_dir,
                                              "metrics.json"))
    return metrics


if __name__ == "__main__":
    main()
