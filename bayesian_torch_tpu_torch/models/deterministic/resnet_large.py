"""Deterministic ImageNet ResNet-18..152 (counterpart of
``bayesian_torch_tpu/models/deterministic/resnet_large.py``): the
torchvision-style twin, ``torch.nn.Conv2d`` / ``Linear`` layers and the
port's ``BatchNorm2d``, with torchvision's ``state_dict`` keys. Model-zoo
downloads (``pretrained=True``) raise; warm-start with
``utils.checkpoint.load_jax_state`` or ``load_state_dict``.

    model = resnet50(generator=torch.Generator().manual_seed(0),
                     device="cuda")
"""

from bayesian_torch_tpu_torch.models._large_resnet import (  # noqa: F401
    BasicBlock,
    Bottleneck,
    LargeResNet,
    make_factories,
)

__all__ = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]

globals().update(make_factories(None))
