"""The port's nn.Modules (counterparts of taste_spokenlm_tpu/models)."""
