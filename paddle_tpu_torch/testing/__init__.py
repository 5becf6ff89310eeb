"""Testing aids of the port: deterministic fault injection (`faults`)."""
