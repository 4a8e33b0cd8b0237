#!/bin/bash
# Canonical CIFAR train config: resnet20, lr=0.001, bs=128.
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_bayesian_cifar --mode=train --arch=resnet20 --lr=0.001 --batch-size=128 "$@"
