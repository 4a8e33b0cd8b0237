"""Quantized activation tensor (counterpart of
``bayesian_torch_tpu/ops/qtensor.py``): a uint8 payload with a static
Python float ``scale`` and int ``zp``.

A plain Python class, not a tensor subclass: model-level ops dispatch on
it explicitly.

- ``relu(qt)``  -> max(q, zp)                 (exact)
- ``qt + qt``   -> qa + qb - zp when the quantization parameters match
                   (exact, in int32, so nothing wraps); otherwise an f32
                   add of the dequantized operands, or with
                   ``INT8_RESIDUAL_ADD`` a requantized uint8 add
- max pooling   -> on the uint8 payload (``nn/functional.py``; exact)
- anything else -> ``dequantize()`` first
"""

from __future__ import annotations

import torch

# Residual adds of QTensors whose scales differ: when True, requantize
# both into ``add_q``'s output scale and add in uint8 (the reference's
# add_relu FloatFunctional); when False (default, as in JAX) add the
# dequantized f32 values, which is the more accurate of the two. Read at
# each add.
INT8_RESIDUAL_ADD = False


class QTensor:
    """uint8 activation + static (scale, zero_point)."""

    __slots__ = ("q", "scale", "zp")

    def __init__(self, q, scale: float, zp: int):
        self.q = q
        self.scale = float(scale)
        self.zp = int(zp)

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.dim()

    def reshape(self, *shape):
        """The payload reshaped (a view where torch gives one); the scale
        and zero point are per tensor."""
        return QTensor(self.q.reshape(*shape), self.scale, self.zp)

    def dequantize(self):
        return (self.q.float() - self.zp) * self.scale

    def requantize(self, scale: float, zp: int) -> "QTensor":
        """uint8 -> uint8 rescale to (scale, zp)."""
        if scale == self.scale and zp == self.zp:
            return self
        r = torch.round((self.q.float() - self.zp) * (self.scale / scale)) + zp
        return QTensor(torch.clamp(r, 0, 255).to(torch.uint8), scale, zp)

    def add_q(self, other: "QTensor", scale: float = None,
              zp: int = None) -> "QTensor":
        """uint8 add with requantization into (scale, zp); the default
        scale ``sa + sb`` covers the sum's range."""
        if scale is None:
            scale = self.scale + other.scale
        if zp is None:
            zp = self.zp
        a = (self.q.float() - self.zp) * (self.scale / scale)
        b = (other.q.float() - other.zp) * (other.scale / scale)
        s = torch.round(a + b) + zp
        return QTensor(torch.clamp(s, 0, 255).to(torch.uint8), scale, zp)

    def __add__(self, other):
        if isinstance(other, QTensor):
            if other.scale == self.scale and other.zp == self.zp:
                s = (self.q.to(torch.int32) + other.q.to(torch.int32)
                     - self.zp)
                return QTensor(torch.clamp(s, 0, 255).to(torch.uint8),
                               self.scale, self.zp)
            if INT8_RESIDUAL_ADD:
                return self.add_q(other)
            return self.dequantize() + other.dequantize()
        return self.dequantize() + other

    def __radd__(self, other):
        if isinstance(other, (int, float)) and other == 0:
            return self
        return other + self.dequantize()

    def relu(self) -> "QTensor":
        """max(x, 0) == max(q, zp) in the quantized domain (exact)."""
        return QTensor(torch.clamp_min(self.q, self.zp), self.scale, self.zp)

    def __repr__(self):
        return (f"QTensor(shape={tuple(self.q.shape)}, "
                f"scale={self.scale}, zp={self.zp})")


def relu(x):
    """ReLU on a QTensor (stays uint8) or a tensor."""
    if isinstance(x, QTensor):
        return x.relu()
    return torch.relu(x)


def dequantize_if_qtensor(x):
    return x.dequantize() if isinstance(x, QTensor) else x
