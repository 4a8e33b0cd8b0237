"""Deterministic ResNet on ImageNet (the baseline, and the MOPED source),
the port's trainer (counterpart of
``bayesian_torch_tpu/examples/main_deterministic_imagenet.py``).

    python -m bayesian_torch_tpu_torch.examples.main_deterministic_imagenet \\
        --synthetic --mode=train --epochs=2 --batch-size=32

SGD with momentum 0.9 on the cross-entropy of ``model(x)``, f32; after
training the model is evaluated on a fifth of the data and saved to
``<save_dir>/imagenet_det_<arch>.pt``, which ``main_bayesian_imagenet
--moped --moped-ckpt`` and ``main_bayesian_imagenet_dnn2bnn --det-ckpt``
read. ``--mode=test`` loads it and evaluates. ``--device`` (default
``cuda``) names where the model runs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.examples._data import batches, load_imagenet_val
from bayesian_torch_tpu_torch.examples.main_deterministic_mnist import (
    evaluate_det,
)
from bayesian_torch_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)


def build_parser():
    p = argparse.ArgumentParser(description="Deterministic ImageNet")
    p.add_argument("--arch", type=str, default="resnet50",
                   choices=["resnet18", "resnet34", "resnet50",
                            "resnet101", "resnet152"])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test"])
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--save_dir", type=str,
                   default="./checkpoint/deterministic")
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
        resnet_large as zoo)
    device = torch.device(args.device)
    model = getattr(zoo, args.arch)(
        num_classes=args.num_classes,
        generator=torch.Generator().manual_seed(args.seed), device=device)
    ckpt_path = os.path.join(args.save_dir, f"imagenet_det_{args.arch}.pt")

    if args.mode == "test":
        load_checkpoint(model, ckpt_path)
        return evaluate_det(model, test_data, args.batch_size)
    model.train()
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    for epoch in range(args.epochs):
        for i, (xb, yb) in enumerate(batches(*train_data, args.batch_size,
                                             seed=epoch)):
            xb = torch.from_numpy(xb).to(device)
            yb = torch.from_numpy(yb.astype(np.int64)).to(device)
            optimizer.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            optimizer.step()
            if i % 10 == 0:
                print(f"epoch {epoch} step {i}: loss {loss.item():.4f}")
    acc = evaluate_det(model, test_data, args.batch_size)
    save_checkpoint(model, ckpt_path)
    return acc


if __name__ == "__main__":
    main()
