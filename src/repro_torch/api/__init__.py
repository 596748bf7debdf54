"""Session API of the port (ports ``src/repro/api``)."""
