"""Bayesian (reparameterization) model factories."""
