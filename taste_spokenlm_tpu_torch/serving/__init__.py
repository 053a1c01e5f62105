"""Serving engine of the port (counterpart of taste_spokenlm_tpu/serving):
TasteEngine's token bucketing, tokenize, reconstruct and the streaming
entry points."""
