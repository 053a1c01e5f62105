"""Training of the port: optimizer, schedules, freeze masks, the train steps
and the training loop (counterpart of the JAX package's train/)."""
