"""The FHE client of the port (``FHEClient``)."""
