"""Host-side front end of the port (counterpart of taste_spokenlm_tpu/
frontend): streaming synthesis and the pipelined completion stream, the
completion pipeline (api.py) and the processor (processor.py)."""
