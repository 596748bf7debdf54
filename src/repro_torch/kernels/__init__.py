"""Hand-written Hopper kernels of the port (ports ``src/repro/kernels``)."""
