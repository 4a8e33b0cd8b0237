"""Deterministic CIFAR ResNet (the baseline, and the MOPED source), the
port's trainer (counterpart of
``bayesian_torch_tpu/examples/main_deterministic_cifar.py``).

    python -m bayesian_torch_tpu_torch.examples.main_deterministic_cifar \\
        --synthetic --epochs=1

SGD with momentum 0.9 under the JAX trainer's learning rate, optax's
``cosine_decay_schedule(lr, epochs * 400)`` counted in optimizer steps
(``_engine.cosine_decay_schedule``), on the cross-entropy of the logits,
f32. After training the model is evaluated on the test split and saved to
``<save_dir>/cifar_det_<arch>.pt``, which ``main_bayesian_cifar --moped
--moped-ckpt`` reads; ``--mode=test`` loads it and evaluates. ``--device``
(default ``cuda``) names where the model runs. Evaluation drops the last
partial batch, so ``--test-batch-size`` must not exceed the test split.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples._data import batches, load_cifar10
from bayesian_torch_tpu_torch.examples.main_deterministic_mnist import (
    evaluate_det,
)
from bayesian_torch_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)


def build_parser():
    p = argparse.ArgumentParser(description="Deterministic CIFAR10")
    p.add_argument("--arch", type=str, default="resnet20",
                   choices=["resnet20", "resnet32", "resnet44", "resnet56",
                            "resnet110"])
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--test-batch-size", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test"])
    p.add_argument("--save_dir", type=str,
                   default="./checkpoint/deterministic")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    train_data, test_data = load_cifar10(args.data_dir, args.synthetic)

    from bayesian_torch_tpu_torch.models.deterministic import resnet as zoo
    device = torch.device(args.device)
    model = getattr(zoo, args.arch)(
        generator=torch.Generator().manual_seed(args.seed), device=device)
    ckpt_path = os.path.join(args.save_dir, f"cifar_det_{args.arch}.pt")

    if args.mode == "test":
        load_checkpoint(model, ckpt_path)
        return evaluate_det(model, test_data, args.test_batch_size)
    model.train()
    schedule = engine.cosine_decay_schedule(args.lr, args.epochs * 400)
    optimizer = torch.optim.SGD(model.parameters(), lr=schedule(0),
                                momentum=0.9)
    scheduler = engine.step_scheduler(optimizer, schedule)
    for epoch in range(args.epochs):
        for i, (xb, yb) in enumerate(batches(*train_data, args.batch_size,
                                             seed=epoch)):
            xb = torch.from_numpy(xb).to(device)
            yb = torch.from_numpy(yb.astype(np.int64)).to(device)
            optimizer.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(xb), yb)
            loss.backward()
            optimizer.step()
            scheduler.step()
            if i % 50 == 0:
                print(f"epoch {epoch} step {i}: loss {loss.item():.4f}")
    acc = evaluate_det(model, test_data, args.test_batch_size)
    save_checkpoint(model, ckpt_path)
    return acc


if __name__ == "__main__":
    main()
