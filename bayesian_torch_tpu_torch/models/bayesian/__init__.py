"""Bayesian (reparameterization and Flipout) model factories."""
