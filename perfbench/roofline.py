"""The table of peaks and the least time a kernel class could take for a
unit of the cell's work (a predicted batch, a training step).

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once, from the shapes) at the HBM
rate, and its operations at the published peak of their precision. It is
taken from the work and never from an implementation's instruction
count, so whatever computes the work reads the same bound, and no share
of it can pass 100 % unless the time leaves out part of the work.

Peaks: NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W
power limit.
"""

from __future__ import annotations

from perfbench.arch import Arch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12,
                  "int8": 1979e12, "tf32": 495e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_ms(nbytes: float, ops: float = 0.0,
             precision: str = "float32") -> float:
    return max(nbytes / HBM_BYTES_PER_S,
               ops / PEAK_OPS_PER_S[precision]) * 1e3


def sampler_bound_ms(n: int, draws: int, in_bytes: int = 4,
                     out_bytes: int = 2) -> float:
    """Drawing ``draws`` weight sets of ``n`` elements from mu and rho
    (read once, ``in_bytes`` each) into ``draws * n`` outputs: one
    multiply-add an element a draw in float32."""
    return bound_ms(n * 2 * in_bytes + draws * n * out_bytes,
                    2.0 * draws * n, "float32")


def noise_grad_bound_ms(n: int, draws: int, g_bytes: int = 2,
                        out_bytes: int = 4) -> float:
    """The gradient of the noise scale, sum_s g_s * eps_s: ``draws * n``
    gradients read, ``n`` written."""
    return bound_ms(draws * n * g_bytes + n * out_bytes, 2.0 * draws * n,
                    "float32")


def flip_bound_ms(elements: int, nbytes: int = 2) -> float:
    """x * sign over ``elements``: x read, the product written."""
    return bound_ms(2 * nbytes * elements, elements, "float32")


def combine_bound_ms(elements: int, nbytes: int = 2) -> float:
    """mean + pert * sign over ``elements``: two read, one written."""
    return bound_ms(3 * nbytes * elements, 2.0 * elements, "float32")


def _draw_elems(layer) -> int:
    return layer.weight_numel + (layer.cout if layer.bias else 0)


def sampler_ms(arch: Arch, cfg: dict, mode: str, num_mc: int) -> float:
    """The sampler's bound for a unit: in prediction every weight's S
    draws from its mu and rho (f32 as stored, out in the compute dtype;
    the head's bias is drawn on the host); in a training step each
    layer's S draws of weight and bias and the gradient of their noise
    scale."""
    out = BYTES[cfg["compute_dtype"]]
    if mode == "predict":
        n = sum(layer.weight_numel for layer in arch.layers)
        return sampler_bound_ms(n, num_mc, 4, out)
    total = 0.0
    for layer in arch.layers:
        n = _draw_elems(layer)
        total += sampler_bound_ms(n, num_mc, 4, out)
        total += noise_grad_bound_ms(n, num_mc, out, 4)
    return total


def signs_ms(arch: Arch, cfg: dict, mode: str, num_mc: int,
             batch: int) -> float:
    """The sign work's bound for a predicted batch of a Flipout model:
    every draw flips every layer's input and combines its output, in the
    compute dtype."""
    if cfg["estimator"] != "Flipout" or mode != "predict":
        return 0.0
    nbytes = BYTES[cfg["compute_dtype"]]
    total = 0.0
    for layer in arch.layers:
        total += flip_bound_ms(layer.in_elems(batch), nbytes)
        total += combine_bound_ms(layer.out_elems(batch), nbytes)
    return num_mc * total
