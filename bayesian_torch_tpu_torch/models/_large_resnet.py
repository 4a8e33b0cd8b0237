"""ImageNet ResNet-18..152: deterministic, reparameterization and Flipout
variants (counterpart of ``bayesian_torch_tpu/models/_large_resnet.py``).

torchvision-style ResNet: 7x7 s2 stem - BN - ReLU - maxpool 3x3 s2 -
4 stages - avgpool - fc. Activations are NCHW at the public surface, or,
with ``data_format="NHWC"`` (the JAX flagship's layout), channels-last:
the model takes (B, H, W, 3) and every conv, BatchNorm and pool takes
and returns (B, H, W, C) (``ops/conv.py``); the flatten before ``fc``
gives the same (B, 2048) either way. Parameters and ``state_dict`` keys do
not depend on the layout.

- ``estimator=None``: ``torch.nn.Conv2d(bias=False)`` (under NHWC the
  port's ``nn.Conv2d``, torch's class with ``data_format``) and
  ``torch.nn.Linear`` layers, He-initialised from the model's CPU
  generator (conv N(0, sqrt(2 / (k*k*out))), linear U(+-1/sqrt(in)));
  the forward returns bare logits. Its ``state_dict`` has torchvision's
  keys. It is also the forward of a model converted by ``dnn_to_bnn``,
  whose Bayesian twins return bare outputs (``dnn_to_bnn_flag``).
- ``"Reparameterization"`` / ``"Flipout"``: Bayesian layers; downsample
  paths are ``Sequential(Conv-Bayes, BatchNorm2dLayer)`` threading
  (x, kl) tuples, and the forward returns ``(logits, kl)``.

Every BatchNorm is the port's MC-aware ``BatchNorm2d``
(``layers/batchnorm.py``), as the JAX model uses its own, so
``mc_forward`` can train with one EMA update per step. ReLU, the residual
add and the pools take the uint8 ``QTensor`` activations of a converted
INT8 model (``nn/functional.py``, ``ops/qtensor.py``), in both forwards.

``remat_blocks`` (JAX ``_block_call``): ``True`` puts each residual block
behind a checkpoint that saves only the block's input, and the backward
runs the block again; ``"conv_out"`` also keeps every convolution's output
and recomputes only what lies between them (BatchNorm, ReLU, the add, the
weight draws). The recompute draws the weights its forward drew and moves
no BatchNorm statistic (``ops/remat.py``, which also says what the
``"conv_out"`` policy can see: a draw through K-A, or a conv through K-G,
is a call into our own library and is always recomputed). Without
gradients (eval, ``torch.no_grad``) the blocks run as they are.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    default_generator,
)
from bayesian_torch_tpu_torch.layers.batchnorm import (BatchNorm2d,
                                                       BatchNorm2dLayer)
from bayesian_torch_tpu_torch.nn import (AdaptiveAvgPool2d, Conv2d,
                                        MaxPool2d, Sequential)
from bayesian_torch_tpu_torch.nn import functional as F
from bayesian_torch_tpu_torch.ops import remat
from bayesian_torch_tpu_torch.ops.conv import channels_last
from bayesian_torch_tpu_torch.utils import tracing

prior_mu = 0.0
prior_sigma = 1.0
posterior_mu_init = 0.0
posterior_rho_init = -3.0


def _deterministic_factories(generator, device, data_format="NCHW"):
    """He-initialised conv and linear layers, every weight
    drawn from ``generator`` (a fresh ``default_generator()`` if None) on
    the CPU and moved to ``device`` (the JAX model's ``_he_init``; its
    linear keeps torch's default U(+-1/sqrt(in)))."""
    if generator is None:
        generator = default_generator()
    # skip_init: no default init drawn from torch's global generator
    device = device if device is not None else "cpu"

    def draw(module, init):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(init(p.shape))
        return module

    # a channels-last model takes the port's nn.Conv2d (torch's, with
    # ``data_format``); an NCHW one keeps torch's own class
    if channels_last(data_format):
        kw_format = dict(data_format=data_format)
        conv_cls = Conv2d
    else:
        kw_format, conv_cls = {}, nn.Conv2d

    def conv(cin, cout, k, **kw):
        std = math.sqrt(2.0 / (k * k * cout))
        return draw(nn.utils.skip_init(conv_cls, cin, cout, k, bias=False,
                                       device=device, **kw_format, **kw),
                    lambda shape: std * torch.randn(shape,
                                                    generator=generator))

    def linear(cin, cout):
        bound = 1.0 / math.sqrt(cin)
        return draw(nn.utils.skip_init(nn.Linear, cin, cout, device=device),
                    lambda shape: bound * (2 * torch.rand(
                        shape, generator=generator) - 1))
    return conv, linear


def _layer_factories(estimator, generator, device, data_format="NCHW"):
    from bayesian_torch_tpu_torch import layers

    if estimator is None:
        return _deterministic_factories(generator, device, data_format)
    if estimator not in ("Reparameterization", "Flipout"):
        raise NotImplementedError(
            f"estimator={estimator!r}: None, 'Reparameterization' and "
            "'Flipout' are ported")
    conv_cls = getattr(layers, f"Conv2d{estimator}")
    linear_cls = getattr(layers, f"Linear{estimator}")
    bkw = dict(prior_mean=prior_mu, prior_variance=prior_sigma,
               posterior_mu_init=posterior_mu_init,
               posterior_rho_init=posterior_rho_init, generator=generator,
               device=device)

    def conv(cin, cout, k, **kw):
        return conv_cls(cin, cout, k, bias=False, data_format=data_format,
                        **bkw, **kw)

    def linear(cin, cout):
        return linear_cls(cin, cout, **bkw)
    return conv, linear


class _Block(nn.Module):
    def _res(self, x):
        """Run the downsample (tuple-threading) or identity residual."""
        if self.downsample is None:
            return x, 0.0
        out = self.downsample(x)
        if isinstance(out, tuple):
            return out
        return out, 0.0


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, *,
                 estimator, generator, device=None, data_format="NCHW"):
        super().__init__()
        conv, _ = _layer_factories(estimator, generator, device, data_format)
        bn = dict(device=device, data_format=data_format)
        self.estimator = estimator
        self.conv1 = conv(inplanes, planes, 3, stride=stride, padding=1)
        self.bn1 = BatchNorm2d(planes, **bn)
        self.conv2 = conv(planes, planes, 3, stride=1, padding=1)
        self.bn2 = BatchNorm2d(planes, **bn)
        self.downsample = downsample

    @tracing.spanned("block")
    def forward(self, x):
        if self.estimator is None:
            out = F.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            residual, _ = self._res(x)
            return F.relu(out + residual)
        kl_sum = 0.0
        out, kl = self.conv1(x)
        kl_sum += kl
        out = F.relu(self.bn1(out))
        out, kl = self.conv2(out)
        kl_sum += kl
        out = self.bn2(out)
        residual, kl = self._res(x)
        kl_sum += kl
        return F.relu(out + residual), kl_sum


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, *,
                 estimator, generator, device=None, data_format="NCHW"):
        super().__init__()
        conv, _ = _layer_factories(estimator, generator, device, data_format)
        bn = dict(device=device, data_format=data_format)
        self.estimator = estimator
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes, **bn)
        self.conv2 = conv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = BatchNorm2d(planes, **bn)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4, **bn)
        self.downsample = downsample

    @tracing.spanned("block")
    def forward(self, x):
        if self.estimator is None:
            out = F.relu(self.bn1(self.conv1(x)))
            out = F.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            residual, _ = self._res(x)
            return F.relu(out + residual)
        kl_sum = 0.0
        out, kl = self.conv1(x)
        kl_sum += kl
        out = F.relu(self.bn1(out))
        out, kl = self.conv2(out)
        kl_sum += kl
        out = F.relu(self.bn2(out))
        out, kl = self.conv3(out)
        kl_sum += kl
        out = self.bn3(out)
        residual, kl = self._res(x)
        kl_sum += kl
        return F.relu(out + residual), kl_sum


REMAT_BLOCKS = (False, True, "conv_out")


class LargeResNet(nn.Module):
    def __init__(self, block_cls, layers, num_classes=1000, *,
                 estimator=None, generator: Optional[torch.Generator] = None,
                 device=None, remat_blocks=False, data_format="NCHW"):
        super().__init__()
        if remat_blocks not in REMAT_BLOCKS:
            raise ValueError(f"remat_blocks={remat_blocks!r}: expected one "
                             f"of {REMAT_BLOCKS}")
        self.remat_blocks = remat_blocks
        self.data_format = data_format
        if generator is None:
            generator = default_generator()
        conv, linear = _layer_factories(estimator, generator, device,
                                        data_format)
        self.estimator = estimator
        self.inplanes = 64
        self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = BatchNorm2d(64, device=device, data_format=data_format)
        self.maxpool = MaxPool2d(3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block_cls, 64, layers[0], 1,
                                       generator, device)
        self.layer2 = self._make_layer(block_cls, 128, layers[1], 2,
                                       generator, device)
        self.layer3 = self._make_layer(block_cls, 256, layers[2], 2,
                                       generator, device)
        self.layer4 = self._make_layer(block_cls, 512, layers[3], 2,
                                       generator, device)
        self.avgpool = AdaptiveAvgPool2d(1, data_format=data_format)
        self.fc = linear(512 * block_cls.expansion, num_classes)

    def _make_layer(self, block_cls, planes, blocks, stride, generator,
                    device):
        df = self.data_format
        conv, _ = _layer_factories(self.estimator, generator, device, df)
        kw = dict(estimator=self.estimator, generator=generator,
                  device=device, data_format=df)
        downsample = None
        if stride != 1 or self.inplanes != planes * block_cls.expansion:
            bn = BatchNorm2d if self.estimator is None else BatchNorm2dLayer
            downsample = Sequential(
                conv(self.inplanes, planes * block_cls.expansion, 1,
                     stride=stride),
                bn(planes * block_cls.expansion, device=device,
                   data_format=df),
            )
        mods = [block_cls(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block_cls.expansion
        for _ in range(1, blocks):
            mods.append(block_cls(self.inplanes, planes, **kw))
        return nn.Sequential(*mods)

    def _block_call(self, block, x):
        """One residual block, behind a checkpoint when ``remat_blocks`` is
        set and gradients are being recorded."""
        if not self.remat_blocks or not torch.is_grad_enabled():
            return block(x)
        return remat.checkpoint(
            block, block, x,
            policy="conv_out" if self.remat_blocks == "conv_out" else None)

    def forward(self, x):
        if self.estimator is None:
            out = self.maxpool(F.relu(self.bn1(self.conv1(x))))
            for layer in (self.layer1, self.layer2, self.layer3,
                          self.layer4):
                for block in layer:
                    out = self._block_call(block, out)
            out = self.avgpool(out)
            return self.fc(out.reshape(out.shape[0], -1))
        kl_sum = 0.0
        out, kl = self.conv1(x)
        kl_sum += kl
        out = F.relu(self.bn1(out))
        out = self.maxpool(out)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                out, kl = self._block_call(block, out)
                kl_sum += kl
        out = self.avgpool(out)
        out = out.reshape(out.shape[0], -1)
        out, kl = self.fc(out)
        kl_sum += kl
        return out, kl_sum


_DEPTHS = {
    "resnet18": (BasicBlock, [2, 2, 2, 2]),
    "resnet34": (BasicBlock, [3, 4, 6, 3]),
    "resnet50": (Bottleneck, [3, 4, 6, 3]),
    "resnet101": (Bottleneck, [3, 4, 23, 3]),
    "resnet152": (Bottleneck, [3, 8, 36, 3]),
}


def make_factories(estimator):
    def make(name, block_cls, layers):
        def factory(pretrained=False, num_classes=1000, *, generator=None,
                    **kwargs):
            if pretrained:
                raise NotImplementedError(
                    "model-zoo URLs are not applicable; load weights with "
                    "utils.checkpoint.load_jax_state or load_state_dict")
            return LargeResNet(block_cls, layers, num_classes,
                               estimator=estimator, generator=generator,
                               **kwargs)
        factory.__name__ = name
        return factory

    return {name: make(name, b, l) for name, (b, l) in _DEPTHS.items()}
