"""Model operations from shapes: the numerator of ``mfu.*``.

Two operations (a multiply and an add) per multiply-add of every conv
and of the head, at the configuration's input size. A draw of a
Reparameterization layer is one product; a Flipout layer computes two
(the mean and the perturbation). A training step counts three forwards
(the forward, and the backward's products for the input and for the
weights). Elementwise work (BatchNorm, ReLU, adds, pools, the draws and
the signs) is not counted, nor is any recomputation.
"""

from __future__ import annotations

from perfbench.arch import Arch


def macs_per_image(arch: Arch) -> int:
    """Multiply-adds of one image through one draw of the model."""
    return sum(layer.macs_per_image for layer in arch.layers)


def products_per_layer(cfg: dict) -> int:
    return 2 if cfg["estimator"] == "Flipout" else 1


def per_unit(arch: Arch, cfg: dict, mode: str, batch: int,
             num_mc: int) -> float:
    """Model operations of one predicted batch or one training step of
    ``batch`` images (the global batch) over ``num_mc`` draws."""
    forward = 2.0 * macs_per_image(arch) * products_per_layer(cfg) \
        * batch * num_mc
    return 3.0 * forward if mode == "train" else forward
