"""Bayesian model zoo (ImageNet ResNets so far)."""
