"""CIFAR ResNet-20..110 in three forms: deterministic, reparameterization
and Flipout (counterpart of ``bayesian_torch_tpu/models/_cifar_resnet.py``).

He et al.'s CIFAR ResNet: conv3x3(3->16) - BN - ReLU - three stages of n
BasicBlocks (16/32/64 planes, stride 2 at the entry of the 2nd and 3rd) -
global average pool - linear(64->classes). The shortcut is option A: the
input subsampled by [::2] and its channels zero-padded by planes // 4 on
each side. Bayesian blocks return ``(out, kl)`` and the model
``(logits, kl)``; the deterministic form (``torch.nn`` layers,
kaiming-normal weights drawn from the model's generator, as the JAX
model's ``_kaiming_init``) returns bare logits.

Under the draw axis (``mc_forward``'s vmap emission, ``_mc_draws`` = S)
activations are (B, S*C, H, W) with draw s in channel block s, so the
shortcut pads each draw's block, not the S*C axis as a whole. A
``QTensor`` input (the INT8 flow with uint8 activations) is padded with
its zero point and keeps its (scale, zp).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as torch_F
from torch import nn

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    default_generator,
)
from bayesian_torch_tpu_torch.layers.batchnorm import BatchNorm2d
from bayesian_torch_tpu_torch.models._large_resnet import _layer_factories
from bayesian_torch_tpu_torch.nn import functional as F

_DEPTHS = {"resnet20": [3, 3, 3], "resnet32": [5, 5, 5],
           "resnet44": [7, 7, 7], "resnet56": [9, 9, 9],
           "resnet110": [18, 18, 18]}


def _pad_channels(x, pad, num_draws=None, value=0):
    """Zero-pad (``value``-pad) the channels of (B, C, H, W) by ``pad`` on
    each side; with ``num_draws`` = S each of the S channel blocks of
    (B, S*C, H, W) is padded on its own."""
    if num_draws:
        padded = _pad_channels(x.unflatten(1, (num_draws, -1)).flatten(0, 1),
                               pad, value=value)
        return padded.unflatten(0, (x.shape[0], num_draws)).flatten(1, 2)
    return torch_F.pad(x, (0, 0, 0, 0, pad, pad), value=value)


def _option_a_shortcut(x, planes, num_draws=None):
    """The option-A shortcut: subsample by [::2] and pad the channels by
    planes // 4 on each side (per draw block under the draw axis). A
    QTensor stays quantized: real 0 is its zero point."""
    pad = planes // 4
    if isinstance(x, F.QTensor):
        q = _pad_channels(x.q[:, :, ::2, ::2], pad, num_draws, value=x.zp)
        return F.QTensor(q, x.scale, x.zp)
    return _pad_channels(x[:, :, ::2, ::2], pad, num_draws)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, stride=1, *, estimator, generator,
                 device=None):
        super().__init__()
        conv, _ = _layer_factories(estimator, generator, device)
        self.estimator = estimator
        self.planes = planes
        self.needs_shortcut = stride != 1 or in_planes != planes
        self.conv1 = conv(in_planes, planes, 3, stride=stride, padding=1)
        self.bn1 = BatchNorm2d(planes, device=device)
        self.conv2 = conv(planes, planes, 3, stride=1, padding=1)
        self.bn2 = BatchNorm2d(planes, device=device)

    def _shortcut(self, x):
        if not self.needs_shortcut:
            return x
        return _option_a_shortcut(x, self.planes,
                                  getattr(self, "_mc_draws", None))

    def forward(self, x):
        if self.estimator is None:
            out = F.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            return F.relu(out + self._shortcut(x))
        kl_sum = 0.0
        out, kl = self.conv1(x)
        kl_sum += kl
        out = F.relu(self.bn1(out))
        out, kl = self.conv2(out)
        kl_sum += kl
        out = self.bn2(out)
        return F.relu(out + self._shortcut(x)), kl_sum


class CifarResNet(nn.Module):
    def __init__(self, num_blocks, num_classes=10, *, estimator=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if generator is None:
            generator = default_generator()
        conv, linear = _layer_factories(estimator, generator, device)
        self.estimator = estimator
        self.in_planes = 16
        self.conv1 = conv(3, 16, 3, stride=1, padding=1)
        self.bn1 = BatchNorm2d(16, device=device)
        self.layer1 = self._make_layer(16, num_blocks[0], 1, generator,
                                       device)
        self.layer2 = self._make_layer(32, num_blocks[1], 2, generator,
                                       device)
        self.layer3 = self._make_layer(64, num_blocks[2], 2, generator,
                                       device)
        self.linear = linear(64, num_classes)
        if estimator is None:
            self._kaiming_init(generator)

    def _make_layer(self, planes, n, stride, generator, device):
        blocks = []
        for s in [stride] + [1] * (n - 1):
            blocks.append(BasicBlock(self.in_planes, planes, s,
                                     estimator=self.estimator,
                                     generator=generator, device=device))
            self.in_planes = planes * BasicBlock.expansion
        return nn.Sequential(*blocks)

    @torch.no_grad()
    def _kaiming_init(self, generator):
        """kaiming_normal (std sqrt(2 / fan_in)) on every conv and linear
        weight, the reference's ``_weights_init``; the linear bias keeps
        torch's U(+-1/sqrt(in))."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                std = math.sqrt(2.0 / (w.numel() // w.shape[0]))
                w.copy_(std * torch.randn(w.shape, generator=generator))

    def forward(self, x):
        if self.estimator is None:
            out = F.relu(self.bn1(self.conv1(x)))
            for layer in (self.layer1, self.layer2, self.layer3):
                out = layer(out)
            out = F.avg_pool_nd(out, out.shape[3])
            return self.linear(out.reshape(out.shape[0], -1))
        kl_sum = 0.0
        out, kl = self.conv1(x)
        kl_sum += kl
        out = F.relu(self.bn1(out))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                out, kl = block(out)
                kl_sum += kl
        out = F.avg_pool_nd(out, out.shape[3])
        out = out.reshape(out.shape[0], -1)
        out, kl = self.linear(out)
        kl_sum += kl
        return out, kl_sum


def make_factories(estimator):
    """resnet20..resnet110 factories for one estimator (None:
    deterministic)."""

    def make(name, blocks):
        def factory(num_classes=10, *, generator=None, device=None):
            return CifarResNet(blocks, num_classes, estimator=estimator,
                               generator=generator, device=device)
        factory.__name__ = name
        return factory

    return {name: make(name, blocks) for name, blocks in _DEPTHS.items()}
