"""The shapes of a configuration: its Bayesian layers, BatchNorms and
blocks, worked out from the numbers of its file alone.

Everything the yardstick derives from a model (operations, bytes, the
plain reference's layers, the names the weights go to) starts here, so
nothing of it is read from the program. A ResNet is described as
torchvision's ``resnet50`` (v1.5: the stride on the 3x3 conv of a
bottleneck) with the file's block counts and widths.
"""

from __future__ import annotations

from typing import NamedTuple


class Layer(NamedTuple):
    """One Bayesian layer: a conv (k x k) or the linear head (k = 0)."""

    name: str
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    bias: bool
    h_in: int   # input side (1 for the head)
    h_out: int  # output side (1 for the head)

    @property
    def weight_shape(self):
        if self.k == 0:
            return (self.cout, self.cin)
        return (self.cout, self.cin, self.k, self.k)

    @property
    def weight_numel(self):
        n = self.cout * self.cin
        return n if self.k == 0 else n * self.k * self.k

    @property
    def macs_per_image(self):
        """Multiply-adds of one image through this layer."""
        return self.h_out * self.h_out * self.weight_numel

    def in_elems(self, batch):
        return batch * self.h_in * self.h_in * self.cin

    def out_elems(self, batch):
        return batch * self.h_out * self.h_out * self.cout


class Block(NamedTuple):
    """A bottleneck: conv1, conv2, conv3 and its BatchNorms, with a
    downsample (conv, BatchNorm) or an identity residual."""

    convs: tuple  # three Layer
    bns: tuple    # three BatchNorm names
    downsample: tuple | None  # (Layer, BatchNorm name)


class Arch(NamedTuple):
    stem: Layer
    stem_bn: str
    blocks: tuple
    head: Layer
    bn_channels: dict  # BatchNorm name -> channels

    @property
    def layers(self):
        """The Bayesian layers in registration order (the program's
        ``iter_bayesian_layers`` order, which is also the forward order)."""
        out = [self.stem]
        for b in self.blocks:
            out.extend(b.convs)
            if b.downsample is not None:
                out.append(b.downsample[0])
        out.append(self.head)
        return out

    @property
    def bn_names(self):
        return list(self.bn_channels)


def _out_side(h, k, stride, pad):
    return (h + 2 * pad - k) // stride + 1


def resnet(cfg: dict) -> Arch:
    """The layers of a bottleneck ResNet described by ``cfg`` (keys
    ``image_size``, ``in_channels``, ``stem_width``, ``widths``,
    ``layers``, ``expansion``, ``num_classes``)."""
    if cfg["block"] != "bottleneck":
        raise ValueError(f"block {cfg['block']!r}: only 'bottleneck' is "
                         "described")
    h = cfg["image_size"]
    stem_w = cfg["stem_width"]
    ho = _out_side(h, 7, 2, 3)
    stem = Layer("conv1", cfg["in_channels"], stem_w, 7, 2, 3, False, h, ho)
    bn_channels = {"bn1": stem_w}
    h = _out_side(ho, 3, 2, 1)  # max pool 3x3 s2 p1
    inplanes, exp = stem_w, cfg["expansion"]
    blocks = []
    for si, (planes, count) in enumerate(zip(cfg["widths"], cfg["layers"])):
        for bi in range(count):
            p = f"layer{si + 1}.{bi}"
            s = (1 if si == 0 else 2) if bi == 0 else 1
            h2 = _out_side(h, 3, s, 1)
            c1 = Layer(f"{p}.conv1", inplanes, planes, 1, 1, 0, False, h, h)
            c2 = Layer(f"{p}.conv2", planes, planes, 3, s, 1, False, h, h2)
            c3 = Layer(f"{p}.conv3", planes, planes * exp, 1, 1, 0, False,
                       h2, h2)
            bns = (f"{p}.bn1", f"{p}.bn2", f"{p}.bn3")
            for name, c in zip(bns, (planes, planes, planes * exp)):
                bn_channels[name] = c
            ds = None
            if bi == 0 and (s != 1 or inplanes != planes * exp):
                ds = (Layer(f"{p}.downsample.0", inplanes, planes * exp, 1, s,
                            0, False, h, h2), f"{p}.downsample.1")
                bn_channels[ds[1]] = planes * exp
            blocks.append(Block((c1, c2, c3), bns, ds))
            inplanes, h = planes * exp, h2
    head = Layer("fc", inplanes, cfg["num_classes"], 0, 1, 0, True, 1, 1)
    return Arch(stem, "bn1", tuple(blocks), head, bn_channels)
