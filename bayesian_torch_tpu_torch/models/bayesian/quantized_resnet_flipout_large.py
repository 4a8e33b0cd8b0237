"""INT8 quantized Bayesian ImageNet ResNets, Flipout (counterpart of
``bayesian_torch_tpu/models/bayesian/quantized_resnet_flipout_large.py``):
the factories of ``quantized_resnet_variational_large.py`` over the
Flipout ResNets, whose quantized layers run two int8 products a forward,
the mean and the perturbation."""

from bayesian_torch_tpu_torch.models.bayesian.\
    quantized_resnet_variational_large import make_q_factories

__all__ = ["qresnet18", "qresnet34", "qresnet50", "qresnet101",
           "qresnet152"]

globals().update(make_q_factories("Flipout"))
