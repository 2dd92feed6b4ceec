"""Synthetic data pipelines (numpy; a copy of the JAX package's)."""
