#!/bin/bash
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_bayesian_flipout_imagenet --mode=train --arch=resnet50 --batch-size=128 --lr=0.001 "$@"
