"""Host-side front end of the port (counterpart of taste_spokenlm_tpu/
frontend): streaming synthesis and the pipelined completion stream."""
