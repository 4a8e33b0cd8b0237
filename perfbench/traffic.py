"""The one generator of traffic: a closed loop over a ring of distinct
synthetic batches, read from ``traffic/<name>.json``.

Parameters (all in the mix's file):
- ``mode``: "predict" (the MC predictive mean of each batch) or
  "train" (one ELBO step a batch);
- ``num_mc``: the weight draws a batch or step takes;
- ``batch``: images a batch or step, over all the cell's chips;
- ``ring``: distinct batches made before the window and taken in turn;
- ``warmup``: batches run in set-up before the window (a training mix
  runs ``check_steps`` steps there, which the comparison follows);
- ``traced``: batches or steps profiled in a ``--trace 1`` run;
- ``checked``: predicted batches the comparison samples from the window;
- ``lr``, ``momentum``: a training mix's SGD.

Images are N(0, 1) in the configuration's layout and size, labels
uniform over its classes: slot j of the ring is a function of the run's
seed and j alone, drawn on the device.
"""

from __future__ import annotations

import torch

from perfbench.weights import mix


def slot(cfg: dict, traffic: dict, seed: int, j: int, device):
    """Batch j of the ring, every row of the whole batch: (x, y)."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, "inputs", j))
    b, h, c = traffic["batch"], cfg["image_size"], cfg["in_channels"]
    shape = (b, h, h, c) if cfg["data_format"] == "NHWC" else (b, c, h, h)
    x = torch.randn(shape, generator=gen, device=device)
    y = torch.randint(0, cfg["num_classes"], (b,), generator=gen,
                      device=device)
    return x, y


def ring(cfg: dict, traffic: dict, seed: int, device, rank: int = 0,
         world: int = 1):
    """The ring: each slot's rows of this rank (``batch / world`` of
    them) and the whole batch's labels."""
    out = []
    rows = traffic["batch"] // world
    for j in range(traffic["ring"]):
        x, y = slot(cfg, traffic, seed, j, device)
        out.append((x[rank * rows:(rank + 1) * rows].clone(), y))
        del x
    return out
