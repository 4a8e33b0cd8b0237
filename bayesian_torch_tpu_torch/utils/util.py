"""Entropy-based uncertainty metrics (counterpart of ``entropy``,
``predictive_entropy`` and ``mutual_information`` in
``bayesian_torch_tpu/utils/util.py``): numpy in, numpy out; CPU tensors
are accepted as arrays. ``get_rho`` and ``MOPED`` come with the MOPED
item (ROADMAP Queue 1 #6)."""

from __future__ import annotations

import numpy as np


def entropy(prob):
    """-sum p log p along the last axis."""
    prob = np.asarray(prob)
    return -1 * np.sum(prob * np.log(prob + 1e-15), axis=-1)


def predictive_entropy(mc_preds):
    """Entropy of the MC-mean predictive distribution; mc_preds of shape
    (MC, N, classes)."""
    return entropy(np.mean(np.asarray(mc_preds), axis=0))


def mutual_information(mc_preds):
    """Predictive entropy minus the mean per-draw entropy."""
    mc_preds = np.asarray(mc_preds)
    return entropy(np.mean(mc_preds, axis=0)) - np.mean(entropy(mc_preds),
                                                        axis=0)
