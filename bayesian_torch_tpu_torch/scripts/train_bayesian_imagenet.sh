#!/bin/bash
# Canonical ImageNet train config: resnet50, bs=128, lr=0.001, MOPED delta=0.5.
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_bayesian_imagenet --mode=train --arch=resnet50 --batch-size=128 --lr=0.001 --moped --delta=0.5 "$@"
