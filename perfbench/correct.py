"""The numbers that decide ``correct``, each compared with its limit.

Prediction (an answer is a batch's MC mean):
- ``mean_gap``: over the checked batches, the largest ||m - r|| / ||r||
  of the program's predictive mean m against the reference's r (the
  Frobenius norms of the (B, N) logits);
- ``kl_gap``: |kl - kl_ref| / |kl_ref| of the KL the window returned.

Training (the first three ELBO steps, taken in set-up through the
window's own call), for each leaf |‖program‖ - ‖reference‖| over the
larger of ‖reference‖ and the median ‖reference‖ of the leaf's group:
- ``grad_*``: of step 1's gradient as the optimizer holds it (SGD's
  momentum buffer after one step);
- ``change_*``: of each leaf's change over the three steps;
- ``running_*``: of each BatchNorm running statistic's change over the
  three steps' EMA updates.
The leaves fall into groups (``group``): ``mu`` and ``rho`` of the
Bayesian layers, ``bn`` the BatchNorms' weights and biases, so that a
fault confined to one group (the noise scale's gradient, BatchNorm's
affine gradient) cannot hide behind the others' leaves.
``<what>_<group>_median_gap`` is the median over the group's leaves (the
numbers compared), ``<what>_<group>_gap`` the group's worst leaf,
``<what>_gap`` the worst leaf of all, ``running_median_gap`` and
``running_gap`` the running statistics', and ``loss_gap`` the largest
|loss - loss_ref| / |loss_ref| of the steps (the worst leaves and the
loss are read, not compared: PERF.md says why). Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of
``grad_*`` and ``change_*``: they move by round-off alone.
"""

from __future__ import annotations

import math
import statistics

import torch

SMALL_LEAF = 1e-3
GROUPS = ("mu", "rho", "bn")


def rel_norm_gap(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-300)


def worst_leaf(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap of norms: |got[k] - want[k]| over the larger
    of want[k] and the median of ``want`` (over the leaves kept)."""
    keys = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in keys)
    worst = 0.0
    for k in keys:
        g = got.get(k, math.nan)
        gap = abs(g - want[k]) / max(want[k], med, 1e-300)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def worst_leaves(got: dict, want: dict, keep=None, k: int = 4) -> list:
    """The ``k`` worst leaves of ``worst_leaf``: (gap, leaf, got, want)."""
    keys = [key for key in want if keep is None or key in keep]
    med = statistics.median(want[key] for key in keys)
    rows = [(abs(got.get(key, math.nan) - want[key])
             / max(want[key], med, 1e-300), key, got.get(key), want[key])
            for key in keys]
    return sorted(rows, key=lambda r: -r[0] if math.isfinite(r[0])
                  else -math.inf)[:k]


def median_leaf(got: dict, want: dict, keep=None) -> float:
    """The median over the leaves of ``worst_leaf``'s gaps."""
    keys = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in keys)
    return statistics.median(abs(got.get(k, math.nan) - want[k])
                             / max(want[k], med, 1e-300) for k in keys)


def group(leaf: str) -> str:
    """A leaf's group: 'mu' or 'rho' for a Bayesian layer's (its key
    starts so: ``mu_kernel``, ``rho_bias``), 'bn' for a BatchNorm's
    weight or bias."""
    key = leaf.rpartition(".")[2]
    for name in ("mu", "rho"):
        if key.startswith(name):
            return name
    return "bn"


def train_numbers(got: dict, want: dict) -> dict:
    """Every candidate number of a training comparison. ``got`` and
    ``want`` hold 'loss' (a list, a step each), 'grad' (step 1's
    gradient norm a leaf), 'change' (each leaf's change over the steps,
    by norm) and 'running' (each BatchNorm running statistic's change
    over the steps, by norm)."""
    keep = moving_leaves(want["grad"])
    out = {"loss_gap": max(rel_gap(a, b)
                           for a, b in zip(got["loss"], want["loss"]))}
    for key in ("grad", "change"):
        out[f"{key}_gap"] = worst_leaf(got[key], want[key], keep)
        for name in GROUPS:
            kept = {k for k in keep if group(k) == name}
            if kept:
                out[f"{key}_{name}_gap"] = worst_leaf(got[key], want[key],
                                                      kept)
                out[f"{key}_{name}_median_gap"] = median_leaf(
                    got[key], want[key], kept)
    out["running_gap"] = worst_leaf(got["running"], want["running"])
    out["running_median_gap"] = median_leaf(got["running"], want["running"])
    return out


def moving_leaves(grad_norms: dict) -> set:
    """The leaves whose reference gradient norm is at least
    ``SMALL_LEAF`` of the median leaf's."""
    med = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v >= SMALL_LEAF * med}


def verdict(numbers: dict, limits: dict) -> bool:
    """True where every number is finite and within its limit."""
    return all(math.isfinite(numbers.get(k, math.nan))
               and numbers[k] <= limit for k, limit in limits.items())


def norms(tensors: dict) -> dict:
    return {k: float(t.double().norm()) for k, t in tensors.items()}


def leaf_change(after: dict, before: dict) -> dict:
    return {k: float((after[k].double() - before[k].double().to(
        after[k].device)).norm()) for k in after}


def checks_line(numbers: dict, limits: dict) -> dict:
    return {k: {"value": numbers.get(k, math.nan), "limit": limits[k]}
            for k in limits}


def finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())
