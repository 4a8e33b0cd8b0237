"""Bayesian CIFAR ResNet (Flipout), the port's trainer (counterpart of
``bayesian_torch_tpu/examples/main_bayesian_flipout_cifar.py``).

    python -m bayesian_torch_tpu_torch.examples.main_bayesian_flipout_cifar \\
        --synthetic --epochs=1 --arch=resnet20

Shares the command line and the trainer with ``main_bayesian_cifar``;
files are written as ``cifar_flipout_<arch>.pt`` and
``cifar_flipout_metrics.json``.
"""

from bayesian_torch_tpu_torch.examples.main_bayesian_cifar import (
    build_parser,
    run,
)


def main(argv=None):
    return run(build_parser("Bayesian Flipout CIFAR10").parse_args(argv),
               "Flipout")


if __name__ == "__main__":
    main()
