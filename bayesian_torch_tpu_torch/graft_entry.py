"""Entry point of the port: one Bayesian ResNet-50 MC forward (counterpart
of ``entry`` in the JAX repository's ``__graft_entry__.py``).

    fn, args = entry()          # on the card
    mean_logits, kl = fn(*args)

By default a reduced smoke: Bayesian ResNet-50 (reparameterization) at
64x64, batch 2, 2 weight draws. With ``BTT_ENTRY_FLAGSHIP=1`` the flagship
configuration: batch 128, 224x224, 10 draws, bf16 compute. The model is
in eval mode, so ``mc_forward`` runs the draw loop with every layer's
draws from one batch-sampler launch. Runs on ``cuda`` unless ``device``
names another device (the tests pass ``"cpu"``).
"""

from __future__ import annotations

import os

import torch

from bayesian_torch_tpu_torch.models.bayesian.resnet_variational_large import (
    resnet50,
)
from bayesian_torch_tpu_torch.parallel import mc_forward


def entry(device=None):
    """Return ``(fn, args)``: ``fn(*args)`` gives the MC-mean logits
    (batch, 1000) and the KL."""
    device = torch.device(device if device is not None else "cuda")
    flagship = os.environ.get("BTT_ENTRY_FLAGSHIP", "") == "1"
    num_mc = 10 if flagship else 2
    model = resnet50(num_classes=1000,
                     generator=torch.Generator().manual_seed(0),
                     device=device)
    model.eval()
    if flagship:
        for mod in model.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.bfloat16

    def forward(model, x):
        outs, kl = mc_forward(model, x, num_mc)
        return outs.float().mean(dim=0), kl

    shape = (128, 3, 224, 224) if flagship else (2, 3, 64, 64)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    return forward, (model, x.to(device))
