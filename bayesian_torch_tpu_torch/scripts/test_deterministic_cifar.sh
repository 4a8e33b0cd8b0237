#!/bin/bash
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_deterministic_cifar --mode=test --arch=resnet20 --test-batch-size=1000 "$@"
