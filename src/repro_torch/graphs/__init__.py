"""Graph generators of the port (ports ``src/repro/graphs``)."""
