"""Plain PyTorch ops of the port (counterparts of taste_spokenlm_tpu/ops)."""
