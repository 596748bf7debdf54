"""The blocked engine's Gauss–Seidel sweep: a CUDA kernel and its plain
version (ports ``src/repro/core/blocked.py::sweep``)."""
