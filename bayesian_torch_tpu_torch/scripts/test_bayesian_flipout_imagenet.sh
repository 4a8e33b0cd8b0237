#!/bin/bash
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_bayesian_flipout_imagenet --mode=test --arch=resnet50 --num_monte_carlo=10 "$@"
