#!/bin/bash
# Canonical MNIST MC eval: bs=10000, 20 MC samples.
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m bayesian_torch_tpu_torch.examples.main_bayesian_mnist --mode=test --test-batch-size=10000 --num_monte_carlo=20 "$@"
