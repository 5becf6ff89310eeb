"""Framework utilities of the port: the ``PDTPU001`` weight file (`io`)."""
