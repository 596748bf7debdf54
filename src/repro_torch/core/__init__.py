"""Engines, graph substrate and incremental state of the port (ports
``src/repro/core``)."""
