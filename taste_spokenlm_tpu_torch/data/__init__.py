"""The training data pipeline and the native wav I/O (counterpart of the
JAX data package)."""
