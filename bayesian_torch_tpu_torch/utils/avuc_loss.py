"""Accuracy-versus-Uncertainty calibration losses (Krishnan & Tickoo,
NeurIPS 2020), counterpart of ``bayesian_torch_tpu/utils/avuc_loss.py``.

``AvULoss`` and ``AUAvULoss`` are ``torch.nn.Module``s on logits,
differentiable through the confidences and the tanh of the uncertainty
(the bin memberships are comparisons and carry no gradient); the soft
counts are masked sums, and the area under the AvU curve is
the trapezoidal rule over 21 thresholds. ``entropy``,
``predictive_entropy``, ``mutual_information``, ``eval_avu`` and
``accuracy_vs_uncertainty`` are numpy metrics.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

EPS = 1e-10


def auc(x, y):
    """Trapezoidal area under the curve y(x); ``x`` sorted in either
    direction (sklearn's ``auc``)."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    area = _trapezoid(y, x)
    return area if x[-1] >= x[0] else -area


def _trapezoid(y, x):
    return 0.5 * torch.sum(torch.diff(x) * (y[1:] + y[:-1]))


def _entropy(prob, eps=EPS):
    return -torch.sum(prob * torch.log(prob + eps), dim=-1)


def _soft_counts(confidences, accurate, certain, unc):
    """tanh-weighted soft counts of the four (accuracy x certainty) bins:
      n_ac: conf * (1 - tanh(u)),        n_au: conf * tanh(u),
      n_ic: (1 - conf) * (1 - tanh(u)),  n_iu: (1 - conf) * tanh(u)."""
    tanh_u = torch.tanh(unc)
    acc = accurate.to(unc.dtype)
    cert = certain.to(unc.dtype)
    n_ac = torch.sum(acc * cert * confidences * (1 - tanh_u))
    n_au = torch.sum(acc * (1 - cert) * confidences * tanh_u)
    n_ic = torch.sum((1 - acc) * cert * (1 - confidences) * (1 - tanh_u))
    n_iu = torch.sum((1 - acc) * (1 - cert) * (1 - confidences) * tanh_u)
    return n_ac, n_au, n_ic, n_iu


class _UncertaintyMixin:
    def entropy(self, prob):
        return _entropy(prob, self.eps)

    def expected_entropy(self, mc_preds):
        return torch.mean(self.entropy(mc_preds), dim=0)

    def model_uncertainty(self, mc_preds):
        return (self.entropy(torch.mean(mc_preds, dim=0))
                - self.expected_entropy(mc_preds))

    def _classify(self, logits, labels, type):
        """(confidences, accurate, uncertainty) of a batch of logits;
        ``type`` 0: predictive entropy, 1: model uncertainty."""
        probs = torch.softmax(logits, dim=1)
        confidences, predictions = torch.max(probs, dim=1)
        unc = self.entropy(probs) if type == 0 else \
            self.model_uncertainty(probs)
        return confidences, labels == predictions, unc


class AvULoss(_UncertaintyMixin, nn.Module):
    """Accuracy vs Uncertainty loss at a fixed uncertainty threshold:
    ``-beta * log(AvU + eps)``."""

    def __init__(self, beta=1):
        super().__init__()
        self.beta = beta
        self.eps = EPS

    def predictive_uncertainty(self, mc_preds):
        return self.entropy(torch.mean(mc_preds, dim=0))

    def accuracy_vs_uncertainty(self, prediction, true_label, uncertainty,
                                optimal_threshold):
        """Hard-count AvU metric."""
        acc = (prediction == true_label).float()
        cert = (uncertainty <= optimal_threshold).float()
        n_ac = torch.sum(acc * cert)
        n_au = torch.sum(acc * (1 - cert))
        n_ic = torch.sum((1 - acc) * cert)
        n_iu = torch.sum((1 - acc) * (1 - cert))
        return (n_ac + n_iu) / (n_ac + n_au + n_ic + n_iu)

    def forward(self, logits, labels, optimal_uncertainty_threshold,
                type=0):
        confidences, accurate, unc = self._classify(logits, labels, type)
        certain = unc <= optimal_uncertainty_threshold
        n_ac, n_au, n_ic, n_iu = _soft_counts(confidences, accurate,
                                              certain, unc)
        avu = (n_ac + n_iu) / (n_ac + n_au + n_ic + n_iu + self.eps)
        return -self.beta * torch.log(avu + self.eps)


class AUAvULoss(_UncertaintyMixin, nn.Module):
    """Area under the AvU curve over 21 thresholds spanning the batch's
    [min, max] uncertainty; returns ``(loss, auc_avu)``."""

    def __init__(self, beta=1):
        super().__init__()
        self.beta = beta
        self.eps = EPS

    def forward(self, logits, labels, type=0):
        confidences, accurate, unc = self._classify(logits, labels, type)
        # thresholds in f32 whatever the logits' dtype, as JAX builds them:
        # the curve and its area then come out in f32
        th_list = torch.linspace(0.0, 1.0, 21, dtype=torch.float32,
                                 device=unc.device)
        umin, umax = torch.min(unc), torch.max(unc)
        unc_ths = umin + th_list * (umax - umin)

        def avu_at(unc_th):
            n_ac, n_au, n_ic, n_iu = _soft_counts(
                confidences, accurate, unc <= unc_th, unc)
            return (n_ac + n_iu) / (n_ac + n_au + n_ic + n_iu + self.eps)

        avus = torch.stack([avu_at(t) for t in unc_ths])
        auc_avu = _trapezoid(avus, th_list)
        loss = -self.beta * torch.log(auc_avu + self.eps)
        return loss, auc_avu


def entropy(prob):
    return -1 * np.sum(prob * np.log(prob + 1e-15), axis=-1)


def predictive_entropy(mc_preds):
    return entropy(np.mean(mc_preds, axis=0))


def mutual_information(mc_preds):
    return entropy(np.mean(mc_preds, axis=0)) - np.mean(entropy(mc_preds),
                                                        axis=0)


def eval_avu(pred_label, true_label, uncertainty):
    """AvU at 21 thresholds spanning [min, max] uncertainty (numpy):
    ``(avu_list, unc_list)``."""
    pred_label = np.asarray(pred_label)
    true_label = np.asarray(true_label)
    uncertainty = np.asarray(uncertainty)
    t_list = np.linspace(0, 1, 21)
    umin, umax = uncertainty.min(), uncertainty.max()
    accurate = pred_label == true_label
    avu_list, unc_list = [], []
    for t in t_list:
        u_th = umin + t * (umax - umin)
        certain = uncertainty <= u_th
        n_ac = np.sum(accurate & certain)
        n_au = np.sum(accurate & ~certain)
        n_ic = np.sum(~accurate & certain)
        n_iu = np.sum(~accurate & ~certain)
        avu_list.append((n_ac + n_iu) / (n_ac + n_au + n_ic + n_iu + 1e-15))
        unc_list.append(u_th)
    return np.asarray(avu_list), np.asarray(unc_list)


def accuracy_vs_uncertainty(pred_label, true_label, uncertainty,
                            optimal_threshold):
    """Hard-count AvU metric (numpy)."""
    pred_label = np.asarray(pred_label)
    true_label = np.asarray(true_label)
    uncertainty = np.asarray(uncertainty)
    accurate = pred_label == true_label
    certain = uncertainty <= optimal_threshold
    n_ac = np.sum(accurate & certain)
    n_au = np.sum(accurate & ~certain)
    n_ic = np.sum(~accurate & certain)
    n_iu = np.sum(~accurate & ~certain)
    return (n_ac + n_iu) / (n_ac + n_au + n_ic + n_iu)
