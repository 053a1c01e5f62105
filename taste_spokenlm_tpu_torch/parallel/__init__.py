"""Data parallelism (counterpart of the JAX parallel package)."""
