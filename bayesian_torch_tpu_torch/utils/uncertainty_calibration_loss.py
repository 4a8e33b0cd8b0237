"""Error-aligned uncertainty and confidence calibration losses, and the
vectorised AvU loss (counterpart of
``bayesian_torch_tpu/utils/uncertainty_calibration_loss.py``):
``torch.nn.Module``s whose soft counts are masked sums, differentiable
through the tanh of the error, the uncertainty and the confidence.
"""

from __future__ import annotations

import torch
from torch import nn

EPS = 1e-10


class EaULoss(nn.Module):
    """Error-aligned Uncertainty loss:

    n_lc = sum over {low error & certain}    of (1-tanh(err))*(1-tanh(unc))
    n_lu = sum over {low error & uncertain}  of (1-tanh(err))*tanh(unc)
    n_hc = sum over {high error & certain}   of tanh(err)*(1-tanh(unc))
    n_hu = sum over {high error & uncertain} of tanh(err)*tanh(unc)
    loss = -beta*log((n_lc+n_hu)/(n_lc+n_lu+n_hc+n_hu)+eps)
    """

    def __init__(self, beta=1):
        super().__init__()
        self.beta = beta
        self.eps = EPS

    def forward(self, error, unc, error_th, unc_th):
        low = (error <= error_th).to(unc.dtype)
        cert = (unc <= unc_th).to(unc.dtype)
        te, tu = torch.tanh(error), torch.tanh(unc)
        n_lc = torch.sum(low * cert * (1 - te) * (1 - tu))
        n_lu = torch.sum(low * (1 - cert) * (1 - te) * tu)
        n_hc = torch.sum((1 - low) * cert * te * (1 - tu))
        n_hu = torch.sum((1 - low) * (1 - cert) * te * tu)
        eau = (n_lc + n_hu) / (n_lc + n_lu + n_hc + n_hu + self.eps)
        return -self.beta * torch.log(eau + self.eps)


class EaCLoss(nn.Module):
    """Error-aligned Confidence loss (certain: conf > conf_th)."""

    def __init__(self, beta=1):
        super().__init__()
        self.beta = beta
        self.eps = EPS

    def forward(self, error, conf, error_th, conf_th):
        low = (error <= error_th).to(conf.dtype)
        cert = (conf > conf_th).to(conf.dtype)
        te = torch.tanh(error)
        n_lc = torch.sum(low * cert * (1 - te) * conf)
        n_lu = torch.sum(low * (1 - cert) * (1 - te) * (1 - conf))
        n_hc = torch.sum((1 - low) * cert * te * conf)
        n_hu = torch.sum((1 - low) * (1 - cert) * te * (1 - conf))
        eac = (n_lc + n_hu) / (n_lc + n_lu + n_hc + n_hu + self.eps)
        return -self.beta * torch.log(eac + self.eps)


class AvULoss(nn.Module):
    """Vectorised AvU loss on logits (predictive entropy as the
    uncertainty)."""

    def __init__(self, beta=1):
        super().__init__()
        self.beta = beta
        self.eps = EPS

    def entropy(self, prob):
        return -torch.sum(prob * torch.log(prob + self.eps), dim=-1)

    def forward(self, logits, labels, unc_th, type=0):
        probs = torch.softmax(logits, dim=1)
        confidences, predictions = torch.max(probs, dim=1)
        unc = self.entropy(probs)
        acc = (labels == predictions).to(confidences.dtype)
        cert = (unc <= unc_th).to(confidences.dtype)
        tu = torch.tanh(unc)
        n_ac = torch.sum(acc * cert * confidences * (1 - tu))
        n_au = torch.sum(acc * (1 - cert) * confidences * tu)
        n_ic = torch.sum((1 - acc) * cert * (1 - confidences) * (1 - tu))
        n_iu = torch.sum((1 - acc) * (1 - cert) * (1 - confidences) * tu)
        avu = (n_ac + n_iu) / (n_ac + n_au + n_ic + n_iu + self.eps)
        return -self.beta * torch.log(avu + self.eps)
