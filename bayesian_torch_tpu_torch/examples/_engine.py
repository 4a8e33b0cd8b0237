"""Shared train/eval engine of the example trainers (counterpart of
``bayesian_torch_tpu/examples/_engine.py``).

One ELBO train step over ``mc_forward`` (by default the vmap emission,
as ``emission="auto"`` resolves in training mode; the draw loop with
``emission="scan"``), one MC-predictive eval step,
AverageMeter-style reporting, and ``torch.save`` training
checkpoints. ``train`` and ``evaluate`` take their batches from the
native loader ``data.DataLoader`` (seed 0, epoch seed = the epoch), as
the JAX engine does, so a trainer of the port sees the JAX trainer's
batches in the JAX trainer's order (ROADMAP F7); ``train_dnn2bnn`` and
``calibrate`` take ``_data.batches``, as the JAX dnn2bnn trainers do.
Batches go to the model's device; ``optax.sgd(lr, m)`` becomes
``torch.optim.SGD(lr, momentum=m)``, ``optax.adam`` ``torch.optim.Adam``
and ``optax.adadelta`` ``torch.optim.Adadelta``. An optax learning-rate
schedule is a function of the optimizer's step count: its twins here
(``piecewise_constant_schedule``, ``cosine_decay_schedule``) are functions
of the same count, and ``step_scheduler`` turns one into a ``LambdaLR``
that ``train`` steps once per optimizer step.

With ``mesh`` (``parallel.make_mesh``; the trainers' ``--mesh-mc``, run
under ``torchrun``: ``mesh_for``) every rank takes its block of each batch
(``parallel.shard_batch``), ``mc_forward(mesh=)`` returns the whole
outputs on every rank, ``make_train_step`` sums the ranks' gradients
(``parallel.reduce_gradients``) before the optimizer step, so every rank
takes the single-process step, and only the mesh's first rank prints,
logs and writes files (``is_writer``).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import time

import numpy as np
import torch

from bayesian_torch_tpu_torch.data import DataLoader
from bayesian_torch_tpu_torch.examples._data import batches
from bayesian_torch_tpu_torch.parallel import (make_mesh, mc_forward,
                                               reduce_gradients, replicate,
                                               shard_batch)
from bayesian_torch_tpu_torch.utils.util import (mutual_information,
                                                 predictive_entropy)


class AverageMeter:
    """Running average tracker (the reference's AverageMeter)."""

    def __init__(self, name, fmt=":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"


def mesh_for(args):
    """The trainers' ``--mesh-mc``: join the ``torchrun`` world
    (``parallel.initialize``; one process without it) and lay
    ``make_mesh(mc=args.mesh_mc)`` over its ranks, the rest of them on
    'data', as the JAX trainers do. None for one process at ``--mesh-mc``
    1. Under a mesh ``--device cuda`` means this rank's card
    (``rank_device``), and the trainer makes its model the first rank's
    (``place``)."""
    import torch.distributed as dist

    from bayesian_torch_tpu_torch.parallel import initialize

    initialize()
    if args.mesh_mc <= 1 and not (dist.is_initialized()
                                  and dist.get_world_size() > 1):
        return None
    mesh = make_mesh(mc=args.mesh_mc)
    if mesh.is_first:
        print(f"mesh: {mesh.shape}")
    return mesh


def place(model, mesh):
    """Make every rank's model the mesh's first rank's: parameters,
    buffers and the layers' generators (``parallel.replicate``)."""
    if mesh is not None:
        replicate(model, mesh)
    return model


def rank_device(device, mesh):
    """The device a trainer's model takes: ``device``, or under a mesh
    this rank's card when ``device`` names a card."""
    device = torch.device(device)
    if mesh is not None and device.type == "cuda":
        return mesh.device
    return device


def is_writer(mesh):
    """Whether this process prints, logs and writes files: the one
    process, or the mesh's first rank."""
    return mesh is None or mesh.is_first


def _device(model):
    """The device of the model's first parameter or buffer (a converted
    INT8 model keeps its weights in buffers)."""
    return next(itertools.chain(model.parameters(), model.buffers())).device


def make_train_step(num_mc: int, batch_size: int, mesh=None,
                    presample: str = "auto", emission: str = "auto"):
    """ELBO step: loss = NLL of the mean over draws of the per-draw
    ``log_softmax`` + KL / batch_size; one optimizer step.

    ``train_step(model, optimizer, x, y)`` returns (loss, nll, kl) as
    detached tensors; the gradients stay in the parameters' ``.grad``.
    With ``mesh``, ``x`` is this rank's block of the batch
    (``shard_batch``) and ``y`` the whole batch's labels; the ranks'
    gradients are summed (``reduce_gradients``) before the step, which is
    then the single-process step on every rank.
    BatchNorm running statistics update inside ``mc_forward`` (one EMA
    update per step for ``num_mc > 1``). ``presample`` and ``emission``
    are passed to ``mc_forward`` ("auto" draws inside the layers in
    training mode and, for ``num_mc > 1``, runs all draws in one forward
    through the vmap emission; ``emission="scan"`` runs the draw loop).
    """

    def train_step(model, optimizer, x, y):
        optimizer.zero_grad(set_to_none=True)
        outs, kl = mc_forward(model, x, num_mc, mesh=mesh,
                              presample=presample, emission=emission)
        log_probs = torch.log_softmax(outs.float(), dim=-1)
        mean_out = log_probs.mean(dim=0)
        nll = -mean_out.gather(1, y.long()[:, None]).mean()
        loss = nll + kl / batch_size
        loss.backward()
        if mesh is not None:
            reduce_gradients(model, mesh)
        optimizer.step()
        return loss.detach(), nll.detach(), kl.detach()

    return train_step


def make_eval_step(num_mc: int, mesh=None, structured: bool = False,
                   emission: str = "auto"):
    """MC predictive step: per-draw class probabilities of shape
    (num_mc, batch, classes), without gradients."""

    def eval_step(model, x):
        with torch.no_grad():
            outs = mc_forward(model, x, num_mc, return_kl=False, mesh=mesh,
                              structured=structured, emission=emission)
            return torch.softmax(outs.float(), dim=-1)

    return eval_step


def piecewise_constant_schedule(init_value, boundaries_and_scales):
    """``optax.piecewise_constant_schedule``: the learning rate at
    optimizer step ``count`` is ``init_value`` times the scale of every
    boundary ``<= count``."""
    def schedule(count):
        value = init_value
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if count >= boundary:
                value *= scale
        return value
    return schedule


def cosine_decay_schedule(init_value, decay_steps):
    """``optax.cosine_decay_schedule`` (alpha 0): ``init_value`` times
    ``0.5 * (1 + cos(pi * t / T))`` at optimizer step t, with t held at
    T = ``decay_steps`` from there on."""
    if decay_steps <= 0:
        raise ValueError(f"cosine_decay_schedule: decay_steps {decay_steps}"
                         " must be positive")

    def schedule(count):
        t = min(count, decay_steps)
        return init_value * 0.5 * (1 + math.cos(math.pi * t / decay_steps))
    return schedule


def step_scheduler(optimizer, schedule):
    """A ``LambdaLR`` that sets every parameter group's learning rate to
    ``schedule(k)`` for optimizer step k (counted from 0), when it is
    stepped once after each optimizer step, as optax counts its steps.
    The optimizer's learning rate must be ``schedule(0)``."""
    base = schedule(0)
    for group in optimizer.param_groups:
        if group["lr"] != base:
            raise ValueError(f"step_scheduler: the optimizer's lr "
                             f"{group['lr']} is not schedule(0) = {base}")
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: schedule(k) / base)


def make_writer(log_dir):
    """A TensorBoard ``SummaryWriter`` on ``log_dir`` (the reference's
    ``--tensorboard``), or None, with a message, when tensorboard cannot
    be imported, as in the JAX engine."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("tensorboard unavailable; skipping scalar logging")
        return None
    return SummaryWriter(log_dir)


def train(model, optimizer, data, *, epochs, batch_size, num_mc=1,
          log_every=50, writer=None, mesh=None, checkpoint_dir=None,
          resume=False, eval_fn=None, scheduler=None):
    """Training loop over (x, y) host arrays.

    With ``checkpoint_dir``, a full training checkpoint (model, optimizer,
    epoch, best_acc, generator states and the scheduler's state) is
    written to ``<checkpoint_dir>/last.pt`` after every epoch;
    ``resume=True`` restores it and continues from the next epoch.
    ``eval_fn(model, epoch) -> acc`` optionally tracks best_acc.
    ``scheduler`` (``step_scheduler``) is stepped after every optimizer
    step. Batches come from ``DataLoader(x, y, batch_size=batch_size)``,
    epoch e from ``loader.epoch(e)``, the JAX engine's order. With
    ``mesh`` only its first rank prints and writes the checkpoint; every
    rank resumes from it.
    """
    from bayesian_torch_tpu_torch.utils.checkpoint import (
        load_training_checkpoint,
        save_training_checkpoint,
    )

    x_all, y_all = data
    device = _device(model)
    step_fn = make_train_step(num_mc, batch_size, mesh)
    say = print if is_writer(mesh) else (lambda *a, **k: None)
    start_epoch, best_acc = 0, 0.0
    last_path = (os.path.join(checkpoint_dir, "last.pt")
                 if checkpoint_dir else None)
    if resume and last_path and os.path.isfile(last_path):
        meta = load_training_checkpoint(last_path, model, optimizer,
                                        scheduler=scheduler)
        start_epoch, best_acc = meta["epoch"], meta["best_acc"]
        say(f"resumed from '{last_path}': epoch {start_epoch}, "
            f"best_acc {best_acc:.4f}")
    loader = DataLoader(x_all, y_all, batch_size=batch_size)
    history = []
    for epoch in range(start_epoch, epochs):
        losses = AverageMeter("loss")
        t0 = time.time()
        seen = 0
        for i, (xb, yb) in enumerate(loader.epoch(epoch)):
            xb = (torch.from_numpy(xb).to(device) if mesh is None
                  else shard_batch(xb, mesh))
            yb = torch.from_numpy(yb).to(device)
            loss, nll, kl = step_fn(model, optimizer, xb, yb)
            if scheduler is not None:
                scheduler.step()
            seen += yb.shape[0]
            if i % log_every == 0:
                loss_f = float(loss)
                losses.update(loss_f, yb.shape[0])
                say(f"epoch {epoch} step {i}: loss {loss_f:.4f} "
                    f"nll {float(nll):.4f} kl {float(kl):.4f}")
        dt = time.time() - t0
        say(f"epoch {epoch}: {losses} | {seen / dt:.1f} imgs/s")
        if writer is not None:
            writer.add_scalar("train/elbo_loss", losses.avg, epoch)
            writer.add_scalar("train/imgs_per_sec", seen / dt, epoch)
        history.append({"epoch": epoch, "loss": losses.avg,
                        "imgs_per_sec": seen / dt})
        if eval_fn is not None:
            best_acc = max(best_acc, float(eval_fn(model, epoch)))
        if last_path and is_writer(mesh):
            save_training_checkpoint(last_path, model, optimizer,
                                     epoch=epoch + 1, best_acc=best_acc,
                                     scheduler=scheduler)
    return history


def make_dnn2bnn_loss(num_mc, batch_size):
    """The dnn2bnn trainers' loss ``loss_fn(model, x, y)``: the
    cross-entropy of the mean over ``num_mc`` draws of the logits (the
    converted layers return bare outputs) + ``get_kl_loss / batch_size``."""
    from bayesian_torch_tpu_torch.models import get_kl_loss

    def loss_fn(model, xb, yb):
        outs = mc_forward(model, xb, num_mc, return_kl=False)
        ce = torch.nn.functional.cross_entropy(outs.float().mean(dim=0),
                                               yb.long())
        return ce + get_kl_loss(model) / batch_size

    return loss_fn


def train_dnn2bnn(model, optimizer, data, *, epochs, batch_size, num_mc,
                  log_every):
    """The dnn2bnn trainers' loop: one optimizer step on
    ``make_dnn2bnn_loss`` per batch of the (x, y) host arrays."""
    loss_fn = make_dnn2bnn_loss(num_mc, batch_size)
    device = _device(model)
    model.train()
    for epoch in range(epochs):
        for i, (xb, yb) in enumerate(batches(*data, batch_size, seed=epoch)):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model, torch.from_numpy(xb).to(device),
                           torch.from_numpy(yb).to(device))
            loss.backward()
            optimizer.step()
            if i % log_every == 0:
                print(f"epoch {epoch} step {i}: loss {loss.item():.4f}")


def calibrate(model, data, batch_size, num_images):
    """Post-training quantization's first half: ``prepare`` the model,
    then forward whole batches of the (x, y) host arrays, in order,
    until ``num_images`` have passed; the caller ``convert``s."""
    from bayesian_torch_tpu_torch.quantization import prepare

    prepare(model)
    device = _device(model)
    seen = 0
    with torch.no_grad():
        for xb, _ in batches(*data, batch_size, shuffle=False):
            model(torch.from_numpy(xb).to(device))
            seen += xb.shape[0]
            if seen >= num_images:
                break


def evaluate(model, data, *, batch_size, num_monte_carlo=20,
             save_probs_to=None, writer=None, epoch=0, mesh=None,
             structured=False, emission="auto"):
    """MC-predictive evaluation: accuracy and the uncertainty metrics,
    optionally a .npy dump of the MC probability stack.

    Batches come from ``DataLoader(x, y, batch_size=batch_size,
    shuffle=False)``, as in the JAX engine, and drop the last partial one,
    so fewer examples than ``batch_size`` leave nothing to evaluate: that
    raises ``ValueError``, as it does in the JAX engine. With ``mesh``
    every rank feeds its block of each batch and gets the whole MC stack
    back; each counts the correct predictions of its block's rows, the
    counts are summed over the mesh's 'data' axis, and only the first rank
    prints and writes.
    """
    x_all, y_all = data
    if len(x_all) < batch_size:
        raise ValueError(
            f"evaluate: {len(x_all)} examples make no full batch of "
            f"{batch_size} (the last partial batch is dropped); use a "
            "batch size of at most the number of test examples")
    device = _device(model)
    eval_fn = make_eval_step(num_monte_carlo, mesh, structured, emission)
    correct = 0
    total = 0
    all_probs = []
    all_labels = []
    t0 = time.time()
    loader = DataLoader(x_all, y_all, batch_size=batch_size, shuffle=False)
    for xb, yb in loader.epoch(0):
        probs = eval_fn(model, torch.from_numpy(xb).to(device)
                        if mesh is None else shard_batch(xb, mesh))
        probs = probs.cpu().numpy()  # (MC, B, C)
        hits = probs.mean(axis=0).argmax(1) == yb
        if mesh is not None:  # this rank's block of the rows
            rows = len(yb) // mesh.shape["data"]
            hits = hits[mesh.coord("data") * rows:][:rows]
        correct += int(hits.sum())
        total += xb.shape[0]
        all_probs.append(probs)
        all_labels.append(yb)
    if mesh is not None:
        from bayesian_torch_tpu_torch.parallel._comm import all_reduce_
        correct = int(all_reduce_(torch.tensor([correct]),
                                  mesh.group("data")))
    dt = time.time() - t0
    probs = np.concatenate(all_probs, axis=1)
    acc = correct / max(total, 1)
    pe = predictive_entropy(probs)
    mi = mutual_information(probs)
    metrics = {"accuracy": acc, "predictive_entropy": float(pe.mean()),
               "mutual_information": float(mi.mean()),
               "imgs_per_sec": total / dt}
    if not is_writer(mesh):
        return metrics
    print(f"test: accuracy {acc * 100:.2f}% | {total / dt:.1f} imgs/s | "
          f"predictive entropy {pe.mean():.4f} | "
          f"mutual information {mi.mean():.4f}")
    if writer is not None:
        writer.add_scalar("val/accuracy", acc, epoch)
        writer.add_scalar("val/predictive_entropy", float(pe.mean()), epoch)
        writer.add_scalar("val/mutual_information", float(mi.mean()), epoch)
    if save_probs_to:
        os.makedirs(os.path.dirname(save_probs_to) or ".", exist_ok=True)
        np.save(save_probs_to, probs)
        print(f"saved MC probabilities to {save_probs_to}")
    return metrics


def save_metrics(metrics, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(metrics, f, indent=2)


def make_optimizer(model, lr, kind="adam", momentum=0.9):
    """``torch.optim.Adam(lr)``, ``torch.optim.Adadelta(lr)`` (rho 0.9 and
    eps 1e-6, the ``optax.adadelta`` defaults) or, for any other ``kind``,
    ``torch.optim.SGD(lr, momentum)``, over every parameter (the JAX
    ``wrt=nnx.Param``)."""
    if kind == "adam":
        return torch.optim.Adam(model.parameters(), lr=lr)
    if kind == "adadelta":
        return torch.optim.Adadelta(model.parameters(), lr=lr, rho=0.9,
                                    eps=1e-6)
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum)
