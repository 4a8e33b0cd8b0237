"""Bayesian ResNet on ImageNet (Flipout), the port's trainer (counterpart
of ``bayesian_torch_tpu/examples/main_bayesian_flipout_imagenet.py``).

    python -m bayesian_torch_tpu_torch.examples.main_bayesian_flipout_imagenet \\
        --synthetic --mode=train --epochs=2 --batch-size=32

Shares the command line and the trainer with ``main_bayesian_imagenet``;
files are written as ``imagenet_flipout_<arch>.pt`` and
``imagenet_flipout_metrics.json``.
"""

from bayesian_torch_tpu_torch.examples.main_bayesian_imagenet import (
    build_parser,
    run,
)


def main(argv=None):
    return run(build_parser("Bayesian Flipout ImageNet").parse_args(argv),
               "Flipout")


if __name__ == "__main__":
    main()
