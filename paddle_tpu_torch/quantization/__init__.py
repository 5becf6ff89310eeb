"""Quantization of the port: the abs-max int8 quantizer (`comms.py`) and
weight-only int8 serving with its parity check (`serving.py`)."""
