"""BNN -> INT8 QBNN model surgery (counterpart of
``bayesian_torch_tpu/models/bnn_to_qbnn.py``).

Walks the module tree and replaces each Bayesian layer (both estimators,
plain and transposed convs) with its ``Quantized<Name>`` twin, harvesting
the calibration scales and zero points from the observers ``prepare()``
inserted into the layer's ``quant_dict`` (qint observers [2:] + quint
observers, as the reference orders them), then calls ``quantize()``. A
Bayesian LSTM keeps its class and has its ``ih`` and ``hh`` blocks
quantized in place, as in the JAX package.
A twin keeps its float layer's ``data_format``, so an NHWC model converts
to an NHWC INT8 model.
Optional conv+BN folding follows the reference's naming rules:
``conv{i}`` with ``bn{i}`` for i in 1..3, and ``downsample =
Sequential(conv, bn)``; each folded BN becomes an ``nn.Identity``. With
``quantize_batchnorm`` (and no folding) every BatchNorm2d becomes a
``QuantizedBatchNorm2d`` (alias ``QBatchNorm2d``, the reference's name).
"""

from __future__ import annotations

import torch
from torch import nn

import bayesian_torch_tpu_torch.layers as bayesian_layers
from bayesian_torch_tpu_torch.layers.base_variational_layer import (
    BaseVariationalLayer,
)
from bayesian_torch_tpu_torch.layers.batchnorm import QuantizedBatchNorm2d
from bayesian_torch_tpu_torch.layers.quantized_base import (
    _QuantizedLayerBase,
)
from bayesian_torch_tpu_torch.ops.int8 import symmetric_scale
from bayesian_torch_tpu_torch.ops.qtensor import QTensor


# the reference's name for the quantized BatchNorm2d
QBatchNorm2d = QuantizedBatchNorm2d


def get_scale_and_zero_point(x, upper_bound: float = 100,
                             target_range: int = 255):
    """Symmetric per-tensor INT8 qparams: (2*clamp(max|x|, 0,
    upper_bound)/target_range as a Python float, 0)."""
    return float(symmetric_scale(x, upper_bound, target_range, 0.0)), 0


def get_quantized_tensor(x, default_scale: float = 0.1):
    """Quantize a float tensor to a symmetric int8 QTensor (zero point 0);
    ``default_scale`` replaces a zero scale."""
    scale, zp = get_scale_and_zero_point(x)
    if scale == 0:
        scale = default_scale
    q = torch.clamp(torch.round(x * (1.0 / scale)), -128, 127)
    return QTensor(q.to(torch.int8), scale, zp)


def _harvest_quant_dict(d):
    """quant_dict = qint observers [2:] + quint observers, as
    ``{"scale", "zero_point"}`` dicts; None when the layer was not
    prepared or saw no calibration data (the uncalibrated path). The
    quant_dict is per tensor: per-channel qparams raise."""
    if not getattr(d, "quant_prepare", False):
        return None
    obs = list(d.qint_quant)[2:] + list(d.quint_quant)
    if not all(ob.observed for ob in obs):
        return None
    qd = []
    for ob in obs:
        scale, zp = ob.calculate_qparams()
        if getattr(scale, "ndim", 0) > 0:
            raise ValueError(
                "the quant_dict of a quantized layer is per tensor, but "
                f"{type(ob).__name__} gave per-channel qparams; calibrate "
                "with MinMaxObserver or HistogramObserver in the QConfig "
                "passed to prepare()")
        qd.append({"scale": scale, "zero_point": zp})
    return qd


def _copy_layer_state(qbnn_layer, d):
    """Move the float posterior, the bias flag, the calibration result,
    the generator and the mode from the float layer to its quantized
    twin."""
    for attr in ("mu_weight", "rho_weight", "mu_kernel", "rho_kernel",
                 "mu_bias", "rho_bias"):
        if getattr(d, attr, None) is not None:
            setattr(qbnn_layer, attr, getattr(d, attr))
    qbnn_layer.bias = getattr(d, "mu_bias", None) is not None
    qbnn_layer.quant_dict = _harvest_quant_dict(d)
    qbnn_layer.generator = d.generator
    qbnn_layer.dnn_to_bnn_flag = d.dnn_to_bnn_flag
    qbnn_layer.train(d.training)


def _twin(d):
    return getattr(bayesian_layers, "Quantized" + type(d).__name__)


def _conv_twin(d):
    return _twin(d)(in_channels=d.in_channels, out_channels=d.out_channels,
                    kernel_size=d.kernel_size, stride=d.stride,
                    padding=d.padding, dilation=d.dilation, groups=d.groups,
                    output_padding=getattr(d, "output_padding", 0),
                    data_format=getattr(d, "data_format", "NCHW"))


def qbnn_linear_layer(d):
    qbnn_layer = _twin(d)(in_features=d.in_features,
                          out_features=d.out_features)
    _copy_layer_state(qbnn_layer, d)
    qbnn_layer.quantize()
    return qbnn_layer


def qbnn_lstm_layer(d):
    """Quantize a Bayesian LSTM's ``ih`` and ``hh`` blocks in place (the
    reference looks up a ``QuantizedLSTM*`` class it does not have); the
    LSTM then runs its quantized cell. Blocks already quantized stay."""
    for name in ("ih", "hh"):
        block = getattr(d, name)
        if not isinstance(block, _QuantizedLayerBase):
            setattr(d, name, qbnn_linear_layer(block))
    return d


def qbnn_conv_layer(d):
    qbnn_layer = _conv_twin(d)
    _copy_layer_state(qbnn_layer, d)
    qbnn_layer.quantize()
    return qbnn_layer


def qbnn_batchnorm2d_layer(d):
    """The ``QuantizedBatchNorm2d`` twin of a BatchNorm2d: the same
    statistics, affine parameters, mode and ``stats_frozen``."""
    state = d.state_dict()
    device = next(iter(state.values())).device if state else None
    q = QuantizedBatchNorm2d(d.num_features, d.eps, d.momentum, d.affine,
                             d.track_running_stats, device=device,
                             data_format=getattr(d, "data_format", "NCHW"))
    q.load_state_dict(state)
    q.train(d.training)
    q.stats_frozen = getattr(d, "stats_frozen", False)
    return q


def batch_norm_folding(conv, bn):
    """The quantized twin of ``conv`` with ``bn``'s affine and running
    statistics folded in."""
    qbnn_layer = _conv_twin(conv)
    _copy_layer_state(qbnn_layer, conv)
    qbnn_layer.bn_weight = bn.weight.detach()
    qbnn_layer.bn_bias = bn.bias.detach()
    qbnn_layer.bn_running_mean = bn.running_mean
    qbnn_layer.bn_running_var = bn.running_var
    qbnn_layer.bn_eps = bn.eps
    qbnn_layer.quantize()
    return qbnn_layer


def _is_float_bayes(mod, kind):
    return (isinstance(mod, BaseVariationalLayer)
            and not isinstance(mod, _QuantizedLayerBase)
            and kind in type(mod).__name__)


def bnn_to_qbnn(m: nn.Module, fuse_conv_bn: bool = False,
                quantize_activations: bool = False,
                quantize_batchnorm: bool = False):
    """In-place surgery: Bayesian layers -> quantized twins.

    ``quantize_activations=True`` sets ``q_output`` on every quantized
    conv, so activations stay uint8 ``QTensor``s between layers; linear
    layers emit f32, so a model's head returns a tensor.
    ``quantize_batchnorm=True`` (without ``fuse_conv_bn``) swaps every
    BatchNorm2d for a ``QuantizedBatchNorm2d``, whose output is
    requantized uint8 when its input is a ``QTensor``.
    """
    for name, value in list(m.named_children()):
        if isinstance(value, _QuantizedLayerBase):
            continue
        if _is_float_bayes(value, "LSTM"):
            qbnn_lstm_layer(value)
        elif _is_float_bayes(value, "Conv"):
            if not fuse_conv_bn:  # fused convs are folded below by name
                ql = qbnn_conv_layer(value)
                ql.q_output = quantize_activations
                setattr(m, name, ql)
        elif _is_float_bayes(value, "Linear"):
            setattr(m, name, qbnn_linear_layer(value))
        elif quantize_batchnorm and not fuse_conv_bn \
                and isinstance(value, nn.BatchNorm2d) \
                and not isinstance(value, QuantizedBatchNorm2d):
            setattr(m, name, qbnn_batchnorm2d_layer(value))
        elif not isinstance(value, BaseVariationalLayer):
            bnn_to_qbnn(value, fuse_conv_bn=fuse_conv_bn,
                        quantize_activations=quantize_activations,
                        quantize_batchnorm=quantize_batchnorm)

    if not fuse_conv_bn:
        return
    pairs = [(m, f"conv{i}", f"bn{i}") for i in "123"]
    ds = getattr(m, "downsample", None)
    if isinstance(ds, nn.Sequential) and len(ds) == 2:
        pairs.append((ds, "0", "1"))
    for parent, cname, bname in pairs:
        conv = getattr(parent, cname, None)
        bn = getattr(parent, bname, None)
        if not _is_float_bayes(conv, "Conv") or bn is None \
                or isinstance(bn, nn.Identity):
            continue
        ql = batch_norm_folding(conv, bn)
        ql.q_output = quantize_activations
        setattr(parent, cname, ql)
        setattr(parent, bname, nn.Identity().train(bn.training))
