"""Checkpoints and metric logging (counterpart of the JAX utils package)."""
