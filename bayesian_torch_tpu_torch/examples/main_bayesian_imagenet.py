"""Bayesian ResNet on ImageNet (reparameterization; the Flipout trainer
``main_bayesian_flipout_imagenet`` shares ``run``), the port's trainer
(counterpart of ``bayesian_torch_tpu/examples/main_bayesian_imagenet.py``).

    python -m bayesian_torch_tpu_torch.examples.main_bayesian_imagenet \\
        --synthetic --mode=train --epochs=2 --batch-size=32

The same command line and loss as the JAX trainer: each step is
``CE(mean over draws of the logits) + KL / batch_size`` through
``mc_forward`` in training mode, SGD with momentum 0.9, f32 compute, the
head's ``impl="xla"``. After every epoch ``<save_dir>/last.pt`` holds the
``--resume`` checkpoint (model, optimizer, epoch, generator states); after
training the model is evaluated on a fifth of the data, saved to
``<save_dir>/imagenet_bayesian_<arch>.pt``, and the metrics written to
``<save_dir>/imagenet_bayesian_metrics.json``. ``--mode=test`` loads the
saved model and evaluates it. ``--device`` (default ``cuda``) names where
the model runs. ``--moped`` initialises the model from a deterministic
ResNet of the same depth (``utils.MOPED`` with ``--delta``): one built
from seed ``--seed + 7``, or loaded from ``--moped-ckpt`` (a
``main_deterministic_imagenet`` checkpoint); it comes before a
``--resume`` load, since checkpoints keep no prior. Evaluation drops the
last partial batch, as the JAX trainer's does, so ``--batch-size`` must
not exceed the test split (51 of the 256 synthetic images).
``--remat`` builds the model with ``remat_blocks=True`` (each residual
block recomputed in the backward, its draws replayed), and
``--structured-mc`` evaluates through ``mc_forward(structured=True)``.
Under ``torchrun --nproc-per-node N`` the trainer spans the N ranks:
``--mesh-mc`` of them carry the draws, the rest the batch
(``_engine.mesh_for``); each step's gradients are summed over the ranks
(``parallel.reduce_gradients``), so every rank takes the one-process
step, and only the first rank prints and writes. ``--resume`` loads on
every rank.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.nn.functional as F

from bayesian_torch_tpu_torch.examples import _engine as engine
from bayesian_torch_tpu_torch.examples._data import batches, load_imagenet_val
from bayesian_torch_tpu_torch.parallel import (mc_forward, reduce_gradients,
                                               shard_batch)
from bayesian_torch_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_training_checkpoint,
    save_checkpoint,
    save_training_checkpoint,
)
from bayesian_torch_tpu_torch.utils.util import MOPED


def build_parser(desc="Bayesian ImageNet"):
    p = argparse.ArgumentParser(description=desc)
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
    p.add_argument("--structured-mc", action="store_true",
                   help="evaluate through mc_forward(structured=True): the "
                        "draws as channel blocks of one forward (falls "
                        "back to the draw loop, with a warning, for a "
                        "model that cannot take them)")
    p.add_argument("--num_mc", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--save_dir", type=str, default="./checkpoint/imagenet")
    p.add_argument("--resume", action="store_true",
                   help="resume from <save_dir>/last.pt (epoch, optimizer, "
                        "generator states)")
    p.add_argument("--moped", action="store_true",
                   help="initialise from a deterministic ResNet (MOPED)")
    p.add_argument("--moped-ckpt", type=str, default=None)
    p.add_argument("--delta", type=float, default=0.5)
    p.add_argument("--mesh-mc", type=int, default=1,
                   help="mesh slots for the MC axis (rest go to data)")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint each residual block (remat_blocks=True):"
                        " only block inputs are kept for the backward, "
                        "which runs each block again on the same draws")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    return p


def get_model(arch, seed, num_classes, device,
              estimator="Reparameterization", remat=False):
    from bayesian_torch_tpu_torch.models.bayesian import (
        resnet_flipout_large, resnet_variational_large)

    zoo = {"Flipout": resnet_flipout_large,
           "Reparameterization": resnet_variational_large}[estimator]
    return getattr(zoo, arch)(num_classes=num_classes,
                              generator=torch.Generator().manual_seed(seed),
                              device=device, remat_blocks=remat)


def run(args, estimator="Reparameterization"):
    mesh = engine.mesh_for(args)
    say = print if engine.is_writer(mesh) else (lambda *a, **k: None)
    x, y = load_imagenet_val(args.data_dir, args.synthetic,
                             num_classes=args.num_classes)
    n_val = max(1, len(x) // 5)
    train_data = (x[n_val:], y[n_val:])
    test_data = (x[:n_val], y[:n_val])

    device = engine.rank_device(args.device, mesh)
    model = get_model(args.arch, args.seed, args.num_classes, device,
                      estimator, remat=args.remat)
    tag = "flipout" if estimator == "Flipout" else "bayesian"
    if args.moped:
        from bayesian_torch_tpu_torch.models.deterministic import (
            resnet_large as det_zoo)
        det = getattr(det_zoo, args.arch)(
            num_classes=args.num_classes,
            generator=torch.Generator().manual_seed(args.seed + 7),
            device=device)
        MOPED(model, det, args.moped_ckpt, args.delta)
        say(f"applied MOPED init (delta={args.delta})")
    engine.place(model, mesh)
    ckpt_path = os.path.join(args.save_dir, f"imagenet_{tag}_{args.arch}.pt")
    num_mc, batch_size = args.num_mc, args.batch_size

    def train_step(model, optimizer, xb, yb):
        optimizer.zero_grad(set_to_none=True)
        outs, kl = mc_forward(model, xb, num_mc, mesh=mesh)
        logits = outs.float().mean(dim=0)
        ce = F.cross_entropy(logits, yb.long())
        loss = ce + kl / batch_size
        loss.backward()
        if mesh is not None:
            reduce_gradients(model, mesh)
        optimizer.step()
        return loss.detach(), ce.detach(), kl.detach()

    if args.mode == "train":
        model.train()
        optimizer = torch.optim.SGD(model.parameters(), lr=args.lr,
                                    momentum=0.9)
        last_path = os.path.join(args.save_dir, "last.pt")
        start_epoch = 0
        if args.resume and os.path.isfile(last_path):
            meta = load_training_checkpoint(last_path, model, optimizer)
            start_epoch = meta["epoch"]
            say(f"resumed from epoch {start_epoch} "
                f"(best_acc {meta['best_acc']:.4f})")
        for epoch in range(start_epoch, args.epochs):
            t0, seen = time.time(), 0
            for i, (xb, yb) in enumerate(batches(*train_data, batch_size,
                                                 seed=epoch)):
                xb = (torch.from_numpy(xb).to(device) if mesh is None
                      else shard_batch(xb, mesh))
                yb = torch.from_numpy(yb).to(device)
                loss, ce, kl = train_step(model, optimizer, xb, yb)
                seen += yb.shape[0]
                if i % 10 == 0:
                    say(f"epoch {epoch} step {i}: loss {float(loss):.4f}"
                        f" ce {float(ce):.4f} kl {float(kl):.4f}")
            say(f"epoch {epoch}: {seen / (time.time() - t0):.1f} imgs/s")
            if engine.is_writer(mesh):
                save_training_checkpoint(last_path, model, optimizer,
                                         epoch=epoch + 1)
        model.eval()
        metrics = engine.evaluate(model, test_data, batch_size=batch_size,
                                  num_monte_carlo=args.num_monte_carlo,
                                  structured=args.structured_mc, mesh=mesh)
        if engine.is_writer(mesh):
            save_checkpoint(model, ckpt_path)
            engine.save_metrics(metrics, os.path.join(
                args.save_dir, f"imagenet_{tag}_metrics.json"))
        return metrics
    load_checkpoint(model, ckpt_path)
    model.eval()
    return engine.evaluate(model, test_data, batch_size=batch_size,
                           num_monte_carlo=args.num_monte_carlo,
                           structured=args.structured_mc, mesh=mesh)


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
