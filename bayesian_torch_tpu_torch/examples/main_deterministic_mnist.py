"""Deterministic SCNN on MNIST (the baseline, and the MOPED source), the
port's trainer (counterpart of
``bayesian_torch_tpu/examples/main_deterministic_mnist.py``).

    python -m bayesian_torch_tpu_torch.examples.main_deterministic_mnist \\
        --synthetic --epochs=1

Adadelta (``--lr``, rho 0.9, eps 1e-6, the optax defaults) on the
negative log-likelihood of the model's log-probabilities, f32. After
training the model is evaluated on the test split and saved to
``<save_dir>/mnist_det_scnn.pt``; ``--mode=test`` loads it and evaluates.
``--device`` (default ``cuda``) names where the model runs. Evaluation
drops the last partial batch, so ``--test-batch-size`` must not exceed the
test split.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples._data import batches, load_mnist
from bayesian_torch_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)


def build_parser():
    p = argparse.ArgumentParser(description="Deterministic SCNN MNIST")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--test-batch-size", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=14)
    p.add_argument("--lr", type=float, default=1.0)
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


def evaluate_det(model, data, batch_size):
    """Top-1 accuracy of a deterministic model in eval mode over
    ``data`` (the last partial batch dropped)."""
    x_all, y_all = data
    if len(x_all) < batch_size:
        raise ValueError(
            f"evaluate_det: {len(x_all)} examples make no full batch of "
            f"{batch_size} (the last partial batch is dropped)")
    model.eval()
    device = next(model.parameters()).device
    correct = total = 0
    t0 = time.time()
    with torch.no_grad():
        for xb, yb in batches(x_all, y_all, batch_size, shuffle=False):
            logits = model(torch.from_numpy(xb).to(device))
            preds = logits.argmax(dim=1).cpu().numpy()
            correct += int((preds == yb).sum())
            total += xb.shape[0]
    print(f"test: accuracy {correct / total * 100:.2f}% | "
          f"{total / (time.time() - t0):.1f} imgs/s")
    return correct / total


def main(argv=None):
    args = build_parser().parse_args(argv)
    train_data, test_data = load_mnist(args.data_dir, args.synthetic)

    from bayesian_torch_tpu_torch.models.deterministic.simple_cnn import SCNN
    device = torch.device(args.device)
    model = SCNN(generator=torch.Generator().manual_seed(args.seed),
                 device=device)
    ckpt_path = os.path.join(args.save_dir, "mnist_det_scnn.pt")

    if args.mode == "test":
        load_checkpoint(model, ckpt_path)
        return evaluate_det(model, test_data, args.test_batch_size)
    model.train()
    optimizer = engine.make_optimizer(model, args.lr, kind="adadelta")
    for epoch in range(args.epochs):
        for i, (xb, yb) in enumerate(batches(*train_data, args.batch_size,
                                             seed=epoch)):
            xb = torch.from_numpy(xb).to(device)
            yb = torch.from_numpy(yb.astype(np.int64)).to(device)
            optimizer.zero_grad(set_to_none=True)
            loss = F.nll_loss(model(xb), yb)
            loss.backward()
            optimizer.step()
            if i % 50 == 0:
                print(f"epoch {epoch} step {i}: loss {loss.item():.4f}")
    acc = evaluate_det(model, test_data, args.test_batch_size)
    save_checkpoint(model, ckpt_path)
    return acc


if __name__ == "__main__":
    main()
