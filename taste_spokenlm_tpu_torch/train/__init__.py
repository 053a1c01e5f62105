"""Training of the port: optimizer, schedules, freeze masks and the stage-1
step (counterpart of the JAX package's train/)."""
