"""INT8 evaluation of a Bayesian ResNet converted from a deterministic one,
the port's pipeline (counterpart of
``bayesian_torch_tpu/examples/main_bayesian_imagenet_bnn2qbnn.py``).

    python -m bayesian_torch_tpu_torch.examples.main_bayesian_imagenet_bnn2qbnn \\
        --synthetic --batch-size=32 --fuse-conv-bn --quantize-activations

The deterministic zoo model is converted with ``dnn_to_bnn`` (rho_init
-4), its weights optionally loaded from ``--bnn-ckpt`` (a
``main_bayesian_imagenet_dnn2bnn`` checkpoint), and evaluated in float;
then ``quantization.prepare``, three calibration batches of
``--calib-batch-size`` images, ``quantization.convert(fuse_conv_bn=,
quantize_activations=)`` and an INT8 evaluation, whose GEMMs run through
the int8 GEMM kernel (``ops/int8.py``) on the card. Returns both metrics
as ``{"float": ..., "int8": ...}``. ``--device`` (default ``cuda``) names
where the model runs.
"""

from __future__ import annotations

import argparse

import torch

from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples._data import load_imagenet_val
from bayesian_torch_tpu_torch.models import dnn_to_bnn
from bayesian_torch_tpu_torch.quantization import convert
from bayesian_torch_tpu_torch.utils.checkpoint import load_checkpoint


def build_parser():
    p = argparse.ArgumentParser(description="ImageNet BNN->QBNN")
    p.add_argument("--arch", type=str, default="resnet50",
                   choices=["resnet18", "resnet34", "resnet50",
                            "resnet101", "resnet152"])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--calib-batch-size", type=int, default=32)
    p.add_argument("--num_monte_carlo", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--bnn-type", type=str, default="Reparameterization",
                   choices=["Reparameterization", "Flipout"])
    p.add_argument("--bnn-ckpt", type=str, default=None)
    p.add_argument("--fuse-conv-bn", action="store_true")
    p.add_argument("--quantize-activations", action="store_true",
                   help="keep activations uint8 between conv layers")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    x, y = load_imagenet_val(args.data_dir, args.synthetic,
                             num_classes=args.num_classes)
    test_data = (x, y)

    from bayesian_torch_tpu_torch.models.deterministic import (
        resnet_large as det_zoo)
    device = torch.device(args.device)
    model = getattr(det_zoo, args.arch)(
        num_classes=args.num_classes,
        generator=torch.Generator().manual_seed(args.seed), device=device)
    dnn_to_bnn(model, {
        "prior_mu": 0.0, "prior_sigma": 1.0,
        "posterior_mu_init": 0.0, "posterior_rho_init": -4.0,
        "type": args.bnn_type, "moped_enable": False, "moped_delta": 0.5,
    })
    if args.bnn_ckpt:
        load_checkpoint(model, args.bnn_ckpt)
    model.eval()

    print("float BNN eval:")
    float_metrics = engine.evaluate(model, test_data,
                                    batch_size=args.calib_batch_size,
                                    num_monte_carlo=args.num_monte_carlo)

    engine.calibrate(model, (x, y), args.calib_batch_size,
                     3 * args.calib_batch_size)
    convert(model, fuse_conv_bn=args.fuse_conv_bn,
            quantize_activations=args.quantize_activations)

    print("INT8 QBNN eval:")
    int8_metrics = engine.evaluate(model, test_data,
                                   batch_size=args.batch_size,
                                   num_monte_carlo=args.num_monte_carlo)
    return {"float": float_metrics, "int8": int8_metrics}


if __name__ == "__main__":
    main()
