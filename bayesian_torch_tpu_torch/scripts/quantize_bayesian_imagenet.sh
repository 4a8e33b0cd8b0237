#!/bin/bash
# Canonical INT8 ImageNet eval: resnet50, val bs=1, 1 MC sample.
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_bayesian_imagenet_bnn2qbnn --arch=resnet50 --batch-size=1 --num_monte_carlo=1 "$@"
