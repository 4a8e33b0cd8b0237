"""Flipout model zoo: the SCNN and the CIFAR ResNets."""
