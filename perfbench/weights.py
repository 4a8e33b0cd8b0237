"""The weights of a cell, made from ``--seed`` on the device, and the
seeds of everything else a run draws.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference: every posterior mean and rho as the
configuration's factory initialises them (mu ~ N(mu_init, init_std), rho ~
N(rho_init, init_std)), drawn by a ``torch.Generator`` on the card in two
calls (all the means, then all the rhos) and split into the layers. The
BatchNorms keep weight 1 and bias 0; their running statistics are
centred with the second moment that a conv of these weights gives its
channels (``bn_running_var``), so that an eval-mode forward keeps its
activations near unit scale through the depth, as trained statistics do.
"""

from __future__ import annotations

import math

import torch

from perfbench.arch import Arch

_M64 = (1 << 64) - 1
_TAGS = {"weights": 1, "draws": 2, "inputs": 3, "sample": 4}


def mix(seed: int, tag: str, k: int = 0) -> int:
    """A 63-bit seed for stream ``tag`` (and index ``k``) of a run's
    ``--seed``: splitmix64 over the three, so any whole seed works."""
    z = (seed * 0x9E3779B97F4A7C15 + _TAGS[tag] * 0xBF58476D1CE4E5B9
         + k * 0x94D049BB133111EB) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def softplus(x: float) -> float:
    return math.log1p(math.exp(x))


def bn_running_var(arch: Arch, cfg: dict) -> dict:
    """Per BatchNorm, the expected second moment of the conv output it
    normalises: fan-in x E[w^2] x the second moment of the conv's input,
    that moment followed through ReLU (a half), the residual adds and
    the pools from the image's 1."""
    w2 = cfg["init_std"] ** 2 + cfg["posterior_mu_init"] ** 2 \
        + softplus(cfg["posterior_rho_init"]) ** 2

    def var(layer, m_in):
        return layer.cin * layer.k * layer.k * w2 * m_in

    out = {arch.stem_bn: var(arch.stem, 1.0)}
    m = 0.5  # after BN and ReLU (the max pool keeps it near)
    for b in arch.blocks:
        out[b.bns[0]] = var(b.convs[0], m)
        out[b.bns[1]] = var(b.convs[1], 0.5)
        out[b.bns[2]] = var(b.convs[2], 0.5)
        res = m
        if b.downsample is not None:
            out[b.downsample[1]] = var(b.downsample[0], m)
            res = 1.0
        m = (1.0 + res) / 2.0
    return out


def make(arch: Arch, cfg: dict, seed: int, device) -> dict:
    """{'layers': {name: {'mu', 'rho'[, 'mu_bias', 'rho_bias']}},
    'bn': {name: {'weight', 'bias', 'running_mean', 'running_var'}}}, f32
    on ``device``, every value a function of ``seed``."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, "weights"))
    shapes = []
    for layer in arch.layers:
        shapes.append((layer.name, "mu", "rho", layer.weight_shape))
        if layer.bias:
            shapes.append((layer.name, "mu_bias", "rho_bias",
                           (layer.cout,)))
    total = sum(math.prod(s) for *_, s in shapes)
    std = cfg["init_std"]
    mus = torch.randn(total, generator=gen, device=device).mul_(std).add_(
        cfg["posterior_mu_init"])
    rhos = torch.randn(total, generator=gen, device=device).mul_(std).add_(
        cfg["posterior_rho_init"])
    sizes = [math.prod(s) for *_, s in shapes]
    layers = {}
    for (name, mu_key, rho_key, shape), mu, rho in zip(
            shapes, mus.split(sizes), rhos.split(sizes)):
        entry = layers.setdefault(name, {})
        entry[mu_key] = mu.view(shape)
        entry[rho_key] = rho.view(shape)
    rv = bn_running_var(arch, cfg)
    bn = {}
    for name, c in arch.bn_channels.items():
        bn[name] = dict(
            weight=torch.ones(c, device=device),
            bias=torch.zeros(c, device=device),
            running_mean=torch.zeros(c, device=device),
            running_var=torch.full((c,), rv[name], device=device))
    return {"layers": layers, "bn": bn}
