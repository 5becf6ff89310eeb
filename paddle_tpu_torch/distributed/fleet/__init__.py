"""The fleet's node registries (`elastic.py`)."""
