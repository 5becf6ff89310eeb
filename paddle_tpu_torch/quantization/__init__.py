"""Quantization of the port: the abs-max int8 quantizer and the blockwise
codec of the quantized all-reduce (`comms.py`), and weight-only int8
serving with its parity check (`serving.py`)."""
