#!/bin/bash
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_bayesian_flipout_cifar --mode=train --arch=resnet20 --lr=0.001 --batch-size=128 "$@"
