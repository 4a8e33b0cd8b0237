"""INT8 quantized Bayesian ImageNet ResNets, reparameterization
(counterpart of
``bayesian_torch_tpu/models/bayesian/quantized_resnet_variational_large.py``).

Each factory builds the float Bayesian ResNet, puts it in eval mode,
``prepare``s it, hands it to ``calibrate`` (a callable that runs
representative batches through the prepared model; without one the
quantized layers take the reference's uncalibrated default scales) and
``convert``s it in place. ``make_q_factories`` builds them for either
estimator (``quantized_resnet_flipout_large.py`` takes the Flipout ones).
"""

from __future__ import annotations

from typing import Callable, Optional

from bayesian_torch_tpu_torch.models._large_resnet import make_factories
from bayesian_torch_tpu_torch.quantization import convert, prepare

__all__ = ["qresnet18", "qresnet34", "qresnet50", "qresnet101",
           "qresnet152"]


def make_q_factories(estimator):
    """{"qresnet18": factory, ...} over ``make_factories(estimator)``."""
    float_factories = make_factories(estimator)

    def make(name):
        float_factory = float_factories[name]

        def factory(num_classes: int = 1000, *, generator=None,
                    calibrate: Optional[Callable] = None,
                    fuse_conv_bn: bool = False,
                    quantize_activations: bool = True, device=None,
                    **kwargs):
            model = float_factory(num_classes=num_classes,
                                  generator=generator, device=device,
                                  **kwargs)
            model.eval()
            prepare(model)
            if calibrate is not None:
                calibrate(model)
            convert(model, fuse_conv_bn=fuse_conv_bn,
                    quantize_activations=quantize_activations)
            return model

        factory.__name__ = "q" + name
        return factory

    return {"q" + name: make(name) for name in float_factories}


globals().update(make_q_factories("Reparameterization"))
