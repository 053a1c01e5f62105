"""Serving layer of the port (counterpart of taste_spokenlm_tpu/serving):
TasteEngine, the micro-batcher, the load test and the gRPC and HTTP
servers."""
