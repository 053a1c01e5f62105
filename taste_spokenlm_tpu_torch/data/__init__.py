"""The training data pipeline (counterpart of the JAX data package)."""
