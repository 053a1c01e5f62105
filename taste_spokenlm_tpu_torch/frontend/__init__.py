"""Host-side front end of the port (counterpart of taste_spokenlm_tpu/
frontend): streaming synthesis and the pipelined completion stream, the
completion pipeline (api.py), the processor (processor.py) and the ONNX
reader, writer and executor (onnx_import.py, onnx_build.py,
onnx_exec.py)."""
