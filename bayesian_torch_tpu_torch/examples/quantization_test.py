"""The shortest INT8 round trip: prepare -> calibrate -> convert of the
Bayesian SCNN (counterpart of
``bayesian_torch_tpu/examples/quantization_test.py``).

    python -m bayesian_torch_tpu_torch.examples.quantization_test

The SCNN from seed 0, in eval mode, is prepared, calibrated on one random
28x28 image, converted, and run once on that image: the convs and both
linears go through the fused int8 GEMM. Prints the output's shape, the KL
and two layers' types; returns ``(log_probs, kl)``. ``--device`` (default
``cuda``) names where the model runs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bayesian_torch_tpu_torch.models.bayesian.simple_cnn_variational import (
    SCNN,
)
from bayesian_torch_tpu_torch.quantization import convert, prepare


def main(argv=None):
    p = argparse.ArgumentParser(description="SCNN INT8 round trip")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    model = SCNN(generator=torch.Generator().manual_seed(0), device=device)
    model.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 1, 28, 28).astype(np.float32)).to(device)

    prepare(model)
    with torch.no_grad():
        model(x)  # one random calibration input
    convert(model)

    out, kl = model(x)
    print("quantized forward:", tuple(out.shape), "kl:", kl)
    print("layer types:", type(model.conv1).__name__,
          type(model.fc2).__name__)
    return out, kl


if __name__ == "__main__":
    main()
