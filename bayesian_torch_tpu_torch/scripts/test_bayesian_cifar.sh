#!/bin/bash
# Canonical CIFAR eval config: bs=1000, 50 MC samples.
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_bayesian_cifar --mode=test --arch=resnet20 --test-batch-size=1000 --num_monte_carlo=50 "$@"
