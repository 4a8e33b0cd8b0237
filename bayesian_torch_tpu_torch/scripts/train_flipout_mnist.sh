#!/bin/bash
# Flipout SCNN MNIST training (uses the flipout model zoo variant).
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec python3 - "$@" <<'PY'
import sys
from bayesian_torch_tpu_torch.examples import main_bayesian_mnist as m
import bayesian_torch_tpu_torch.models.flipout.simple_cnn as flip
m.SCNN = flip.SCNN
m.main(["--mode=train", "--batch-size=64", "--lr=1.0"] + sys.argv[1:])
PY
