#!/bin/bash
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_deterministic_mnist --mode=train --batch-size=64 --lr=1.0 "$@"
