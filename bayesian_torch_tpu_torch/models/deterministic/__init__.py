"""Deterministic model zoo (the MOPED sources and baselines)."""
