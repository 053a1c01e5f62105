"""Checkpoints, metric logging and profiling (counterpart of the JAX utils
package)."""
