"""Synthetic data streams of the port (ports ``src/repro/data``)."""
