#!/bin/bash
# PTQ pipeline on CIFAR: prepare -> 100-sample calibration -> convert -> eval.
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_bayesian_cifar_dnn2bnn --mode=ptq --arch=resnet20 "$@"
