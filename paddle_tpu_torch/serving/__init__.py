"""Serving-fleet pieces of the port. So far the prefix page-chain hash the
engine's prefix store keys on (`disagg.py`); the router and the
disaggregated prefill/decode split come later (ROADMAP A5)."""
